# Port parity: the remaining model builders (mpisppy_tpu_torch/models:
# hydro, aircond, gbd, sizes, usar, apl1p, netdes, battery, distr,
# stoch_distr), the admm wrappers (utils/admmWrapper.py,
# utils/stoch_admmWrapper.py, utils/sputils.py::remap_spec_arrays) and
# sslp's exact recourse value, against the JAX package's on the same
# numpy-seeded inputs.  The builders are numpy in both packages, so every
# comparison here is exact: every ScenarioSpec field equal, the samplers'
# draws equal, the batches the port builds from the wrappers' specs equal
# to the JAX batches leaf by leaf (f32 arrays bit for bit).
import json

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import aircond as jaircond
from mpisppy_tpu.models import apl1p as japl1p
from mpisppy_tpu.models import battery as jbattery
from mpisppy_tpu.models import distr as jdistr
from mpisppy_tpu.models import gbd as jgbd
from mpisppy_tpu.models import hydro as jhydro
from mpisppy_tpu.models import netdes as jnetdes
from mpisppy_tpu.models import sizes as jsizes
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.models import stoch_distr as jstoch_distr
from mpisppy_tpu.models import usar as jusar
from mpisppy_tpu.utils import sputils as jsputils
from mpisppy_tpu.utils.admmWrapper import AdmmWrapper as JAdmmWrapper
from mpisppy_tpu.utils.stoch_admmWrapper import \
    Stoch_AdmmWrapper as JStoch_AdmmWrapper
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.models import aircond as taircond
from mpisppy_tpu_torch.models import apl1p as tapl1p
from mpisppy_tpu_torch.models import battery as tbattery
from mpisppy_tpu_torch.models import distr as tdistr
from mpisppy_tpu_torch.models import gbd as tgbd
from mpisppy_tpu_torch.models import hydro as thydro
from mpisppy_tpu_torch.models import netdes as tnetdes
from mpisppy_tpu_torch.models import sizes as tsizes
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.models import stoch_distr as tstoch_distr
from mpisppy_tpu_torch.models import usar as tusar
from mpisppy_tpu_torch.utils import sputils as tsputils
from mpisppy_tpu_torch.utils.admmWrapper import AdmmWrapper as TAdmmWrapper
from mpisppy_tpu_torch.utils.stoch_admmWrapper import \
    Stoch_AdmmWrapper as TStoch_AdmmWrapper

torch.set_num_threads(1)

SPEC_FIELDS = ("name", "c", "A", "bl", "bu", "l", "u", "nonant_idx", "q",
               "probability", "integer", "var_prob", "soc_blocks")


def _same(a, b, what):
    """Exact equality of two spec field values (dense or scipy-sparse
    arrays, scalars, None)."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if sps.issparse(a) or sps.issparse(b):
        assert sps.issparse(a) and sps.issparse(b), what
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape, what
        a.sort_indices()
        b.sort_indices()
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), what
        return
    if isinstance(a, str):
        assert a == b, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.array_equal(a, b, equal_nan=True), what


def assert_same_spec(js, ts):
    for f in SPEC_FIELDS:
        _same(getattr(js, f), getattr(ts, f), f"{js.name}.{f}")


def _netdes_kw(jm, tm):
    ji = jm.synthetic_instance(n_nodes=8, num_scens=4, seed=3)
    ti = tm.synthetic_instance(n_nodes=8, num_scens=4, seed=3)
    return dict(instance=ji, lp_relax=True), dict(instance=ti,
                                                  lp_relax=True)


def _battery_kw(jm, tm):
    jd, td = jm.getData(num_scens=6, seed=3), tm.getData(num_scens=6, seed=3)
    return (dict(data=jd, use_LP=True, lam=50.0),
            dict(data=td, use_LP=True, lam=50.0))


def _usar_kw(jm, tm):
    kw = dict(num_depots=3, num_sites=6, time_horizon=5,
              num_active_depots=2, seed=1)
    return (dict(instance=jm.generate_instance(**kw), num_scens=4),
            dict(instance=tm.generate_instance(**kw), num_scens=4))


def _distr_kw(jm, tm):
    return (dict(data=jdistr.region_data(3, seed=1)),
            dict(data=tdistr.region_data(3, seed=1)))


# model -> (JAX module, port module, scenario names, per-package kwargs)
MODELS = {
    "hydro": (jhydro, thydro, jhydro.scenario_names_creator(12),
              lambda j, t: ({"branching_factors": (4, 3)},) * 2),
    "aircond": (jaircond, taircond, jaircond.scenario_names_creator(12),
                lambda j, t: ({"branching_factors": (3, 2, 2)},) * 2),
    "gbd": (jgbd, tgbd, jgbd.scenario_names_creator(6),
            lambda j, t: ({"num_scens": 6},) * 2),
    "sizes": (jsizes, tsizes, jsizes.scenario_names_creator(3),
              lambda j, t: ({"scenario_count": 3},) * 2),
    "usar": (jusar, tusar, jusar.scenario_names_creator(4), _usar_kw),
    "apl1p": (japl1p, tapl1p, japl1p.scenario_names_creator(6),
              lambda j, t: ({"num_scens": 6},) * 2),
    "netdes": (jnetdes, tnetdes, jnetdes.scenario_names_creator(4),
               _netdes_kw),
    "battery": (jbattery, tbattery, jbattery.scenario_names_creator(6),
                _battery_kw),
    "distr": (jdistr, tdistr, jdistr.scenario_names_creator(3), _distr_kw),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_spec_parity(model):
    """Every ScenarioSpec field of the port's builder equals the JAX
    builder's, exactly (and distr's column labels)."""
    jm, tm, names, kw = MODELS[model]
    jkw, tkw = kw(jm, tm)
    for nm in names:
        js, ts = jm.scenario_creator(nm, **jkw), tm.scenario_creator(nm, **tkw)
        if model == "distr":
            (js, jv), (ts, tv) = js, ts
            assert jv == tv
        assert type(ts).__module__ == "mpisppy_tpu_torch.core.batch"
        assert_same_spec(js, ts)
    assert tm.scenario_names_creator(3, 2) == jm.scenario_names_creator(3, 2)


def test_stoch_distr_spec_parity():
    """stoch_distr's (scenario, region) pair specs and labels."""
    jd, td = jdistr.region_data(3, seed=2), tdistr.region_data(3, seed=2)
    for snm in jstoch_distr.stoch_scenario_names_creator(3):
        for rnm in jstoch_distr.admm_subproblem_names_creator(3):
            (js, jv) = jstoch_distr.scenario_creator(snm, rnm, data=jd)
            (ts, tv) = tstoch_distr.scenario_creator(snm, rnm, data=td)
            assert jv == tv
            assert_same_spec(js, ts)
        assert tstoch_distr.demand_multiplier(snm) == \
            jstoch_distr.demand_multiplier(snm)
    assert tstoch_distr.consensus_vars_creator(3, td) == \
        jstoch_distr.consensus_vars_creator(3, jd)


def test_sampler_streams():
    """The seeded draws the builders rest on, equal draw for draw."""
    for s in range(12):
        ja, jdm = japl1p.sample(s)
        ta, tdm = tapl1p.sample(s)
        assert np.array_equal(ja, ta) and np.array_equal(jdm, tdm)
        assert np.array_equal(jgbd.sample(s), tgbd.sample(s))
        for k in (1, 3, 10):
            assert tsizes.demand_multiplier(min(s + 1, k), k) == \
                jsizes.demand_multiplier(min(s + 1, k), k)
    jinst, tinst = jusar.generate_instance(seed=4), tusar.generate_instance(
        seed=4)
    for key in jinst:
        assert np.array_equal(jinst[key], tinst[key]), key
    for s in range(6):
        for jv, tv in zip(jusar.sample_scenario(jinst, s, 2),
                          tusar.sample_scenario(tinst, s, 2)):
            assert np.array_equal(jv, tv)
    assert np.array_equal(jbattery.synthetic_solar(7, seed=5),
                          tbattery.synthetic_solar(7, seed=5))
    jd, td = jbattery.getData(num_scens=9, seed=2), tbattery.getData(
        num_scens=9, seed=2)
    for key in ("solar", "M", "N", "rev"):
        assert np.array_equal(jd[key], td[key]), key
    jn = jnetdes.synthetic_instance(num_scens=5, seed=7)
    tn = tnetdes.synthetic_instance(num_scens=5, seed=7)
    for key in ("adj", "c", "p"):
        assert np.array_equal(jn[key], tn[key]), key
    for js, ts in zip(jn["scens"], tn["scens"]):
        for key in ("d", "u", "b"):
            assert np.array_equal(js[key], ts[key]), key
    for bfs in ((2, 2), (3, 3, 2)):
        for s in range(int(np.prod(bfs))):
            assert np.array_equal(jaircond.demands_for_scenario(s, bfs),
                                  taircond.demands_for_scenario(s, bfs))
    jr, tr = jdistr.region_data(4, seed=3), tdistr.region_data(4, seed=3)
    assert jr == tr


def test_gbd_distributions(tmp_path):
    """The 1956 tables by default; the extended JSON read from a
    data_path in both packages alike.  The port has no default path: a
    data_path that does not exist raises there (the JAX package falls
    back to the tables)."""
    for jv, tv in zip(jgbd._distributions(None), tgbd._distributions(None)):
        for a, b in zip(jv, tv):
            assert np.array_equal(a, b)
    ext = {f"r{i + 1}_dmds": [10.0 * i, 10.0 * i + 5.0, 10.0 * i + 9.0]
           for i in range(5)}
    ext.update({f"r{i + 1}_prbs": [0.25, 0.5, 0.25] for i in range(5)})
    path = tmp_path / "gbd_extended_data.json"
    path.write_text(json.dumps(ext))
    for s in range(5):
        assert np.array_equal(jgbd.sample(s, str(path)),
                              tgbd.sample(s, str(path)))
        assert_same_spec(
            jgbd.scenario_creator(f"scen{s}", 5, data_path=str(path)),
            tgbd.scenario_creator(f"scen{s}", 5, data_path=str(path)))
    with pytest.raises(FileNotFoundError):
        tgbd.sample(0, str(tmp_path / "missing.json"))


NETDES_DAT = """/ header comment
An instance of the stochastic network flow problem.
/ more header
+
3
0.5
100
0,1,1;0,0,1;1,0,0
0,10,20;0,0,30;40,0,0
2
0.5,0.5
--Scenarios--
0,1,2;0,0,3;4,0,0
0,5,6;0,0,7;8,0,0
-2,2,0
------------- End of Scenario k = 0 -------
0,2,3;0,0,4;5,0,0
0,6,7;0,0,8;9,0,0
-3,3,0
"""


def test_netdes_parse_dat(tmp_path):
    """A reference-format .dat parsed by both packages, and the specs
    built from it (by path, through the builder's cache, and from the
    parsed instance)."""
    f = tmp_path / "net.dat"
    f.write_text(NETDES_DAT)
    jd, td = jnetdes.parse_dat(str(f)), tnetdes.parse_dat(str(f))
    assert td["n"] == jd["n"] == 3 and len(td["scens"]) == 2
    for key in ("adj", "c", "p"):
        assert np.array_equal(jd[key], td[key])
    for js, ts in zip(jd["scens"], td["scens"]):
        for key in ("d", "u", "b"):
            assert np.array_equal(js[key], ts[key])
    for k in range(2):
        assert_same_spec(
            jnetdes.scenario_creator(f"Scenario{k}", path=str(f)),
            tnetdes.scenario_creator(f"Scenario{k}", path=str(f)))
    with pytest.raises(RuntimeError):
        tnetdes.scenario_creator("Scenario0")


@pytest.mark.parametrize("model,bfs", [("hydro", (3, 3)), ("hydro", (30, 30)),
                                       ("aircond", (3, 3, 2)),
                                       ("aircond", (2, 3))])
def test_trees(model, bfs):
    """make_tree: the same stages, nodes and slot ownership."""
    jm, tm = {"hydro": (jhydro, thydro), "aircond": (jaircond, taircond)}[
        model]
    jt, tt = jm.make_tree(bfs), tm.make_tree(bfs)
    assert tt.branching_factors == jt.branching_factors
    assert tt.nonants_per_stage == jt.nonants_per_stage
    assert tt.num_nodes == jt.num_nodes
    assert tt.all_nodenames() == jt.all_nodenames()
    assert np.array_equal(tt.node_of_slot(), jt.node_of_slot())


def _leaves(obj):
    out = {}

    def walk(d, path):
        if isinstance(d, dict):
            for k, v in d.items():
                if k != "tree":
                    walk(v, f"{path}.{k}")
        elif d is not None and not isinstance(d, (int, tuple)):
            out[path] = np.asarray(d)
    walk(convert.arrays_of(obj), "")
    return out


def assert_same_batch(jb, tb):
    """The port's ScenarioBatch equals the JAX one leaf by leaf (int32
    against int64 index arrays compare by value).  An ELL matrix of the
    port also carries its transposed pattern (ops/sparse.py), which the
    JAX one lacks."""
    la, lb = _leaves(jb), _leaves(tb)
    assert set(lb) - set(la) <= {".qp.A.t_rows", ".qp.A.t_slots"}
    assert set(la) <= set(lb)
    for k in la:
        x, y = la[k], lb[k]
        assert x.shape == y.shape, k
        if x.dtype != y.dtype:
            assert x.dtype.kind == y.dtype.kind == "i", k
            x = x.astype(y.dtype)
        assert np.array_equal(x, y, equal_nan=True), k


def test_remap_spec_arrays():
    jspec, _ = jdistr.scenario_creator("Region1",
                                       data=jdistr.region_data(3, seed=1))
    tspec, _ = tdistr.scenario_creator("Region1",
                                       data=tdistr.region_data(3, seed=1))
    colmap = np.array([7, 0, 6, 5, 2, 3])
    jp = jsputils.remap_spec_arrays(jspec, colmap, 9, 5, scale=3.0)
    tp = tsputils.remap_spec_arrays(tspec, colmap, 9, 5, scale=3.0)
    assert jp.keys() == tp.keys()
    for k in jp:
        _same(jp[k], tp[k], k)


def test_admm_wrapper_parity():
    """AdmmWrapper on distr: the wrapped specs, variable probabilities
    and the batch (the port's on the CPU) equal the JAX wrapper's."""
    R = 3
    jd, td = jdistr.region_data(R, seed=1), tdistr.region_data(R, seed=1)
    names = jdistr.scenario_names_creator(R)
    jw = JAdmmWrapper({}, names, lambda nm, **kw: jdistr.scenario_creator(
        nm, data=jd), jdistr.consensus_vars_creator(R, jd))
    tw = TAdmmWrapper({}, names, lambda nm, **kw: tdistr.scenario_creator(
        nm, data=td), tdistr.consensus_vars_creator(R, td))
    for nm in names:
        assert_same_spec(jw.admmWrapper_scenario_creator(nm),
                         tw.admmWrapper_scenario_creator(nm))
        assert tw.var_prob_list(nm) == jw.var_prob_list(nm)
    assert_same_batch(jw.make_batch(), tw.make_batch(device="cpu"))
    with pytest.raises(RuntimeError, match="not in the model"):
        TAdmmWrapper({}, names, lambda nm, **kw: tdistr.scenario_creator(
            nm, data=td), {nm: ["ghost"] for nm in names})


def test_stoch_admm_wrapper_parity():
    """Stoch_AdmmWrapper on stoch_distr: pair specs, names, tree and
    batch equal the JAX wrapper's."""
    R, S = 3, 2
    jd, td = jdistr.region_data(R, seed=2), tdistr.region_data(R, seed=2)
    stoch = jstoch_distr.stoch_scenario_names_creator(S)
    regions = jstoch_distr.admm_subproblem_names_creator(R)
    jw = JStoch_AdmmWrapper(
        {}, regions, stoch, lambda s, r, **kw: jstoch_distr.scenario_creator(
            s, r, data=jd), jstoch_distr.consensus_vars_creator(R, jd))
    tw = TStoch_AdmmWrapper(
        {}, regions, stoch, lambda s, r, **kw: tstoch_distr.scenario_creator(
            s, r, data=td), tstoch_distr.consensus_vars_creator(R, td))
    assert tw.all_pair_names == jw.all_pair_names
    for nm in jw.all_pair_names:
        assert_same_spec(jw.admmWrapper_scenario_creator(nm),
                         tw.admmWrapper_scenario_creator(nm))
        assert tw.split_admm_stoch_subproblem_scenario_name(nm) == \
            jw.split_admm_stoch_subproblem_scenario_name(nm)
    assert tw.make_tree().branching_factors == jw.make_tree().branching_factors
    assert tw.make_tree().nonants_per_stage == jw.make_tree().nonants_per_stage
    assert_same_batch(jw.make_batch(), tw.make_batch(device="cpu"))


@pytest.mark.parametrize("model", ["hydro", "aircond", "gbd", "sizes",
                                   "usar"])
def test_dense_batches_match_jax(model):
    """The dense shared-A models' batches (the window kernel's inputs on
    the card) equal the JAX batches bit for bit on the CPU."""
    jm, tm, names, kw = MODELS[model]
    jkw, tkw = kw(jm, tm)
    bfs = jkw.get("branching_factors")
    jt, tt = (None, None) if bfs is None else (jm.make_tree(bfs),
                                               tm.make_tree(bfs))
    jb = jbatch.from_specs([jm.scenario_creator(nm, **jkw) for nm in names],
                           tree=jt)
    tb = tbatch.from_specs([tm.scenario_creator(nm, **tkw) for nm in names],
                           tree=tt, device="cpu")
    assert tb.qp.A.ndim == 2     # one dense shared A
    assert_same_batch(jb, tb)


def test_exact_recourse_value_matches_jax():
    """sslp's exact integer recourse value (argmax rounding, 1-opt moves
    and swaps) at random first stages, with and without an LP seed."""
    inst_j = jsslp.synthetic_instance(5, 15, seed=0)
    inst_t = tsslp.synthetic_instance(5, 15, seed=0)
    rng = np.random.RandomState(3)
    for s in range(6):
        cp = jsslp.synthetic_client_present(15, s)
        assert np.array_equal(cp, tsslp.synthetic_client_present(15, s))
        xhat = (rng.rand(5) < 0.6).astype(float)
        y_lp = rng.rand(15, 5) if s % 2 else None
        assert tsslp.exact_recourse_value(inst_t, cp, xhat, y_lp) == \
            jsslp.exact_recourse_value(inst_j, cp, xhat, y_lp)
    # no server open: serve from the cheapest, penalties apply
    cp = jsslp.synthetic_client_present(15, 9)
    assert tsslp.exact_recourse_value(inst_t, cp, np.zeros(5)) == \
        jsslp.exact_recourse_value(inst_j, cp, np.zeros(5))


def test_aircond_program_has_no_in_kernel_draws():
    """aircond's normal walk declares no row_draws: its VirtualBatch
    realizes the batch, scengen.window_inputs refuses it, and the
    realized batch equals the program's materialized one bit for bit."""
    from mpisppy_tpu_torch import scengen
    prog = taircond.scenario_program(12, seed=4, branching_factors=(3, 2, 2))
    assert prog.row_draws is None
    vb = scengen.virtual_batch(prog, device="cpu")
    with pytest.raises(ValueError):
        scengen.window_inputs(vb)
    assert_same_batch(scengen.materialize(prog, device="cpu"), vb.realize())
