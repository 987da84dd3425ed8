# Port parity: the two-stage confidence intervals
# (mpisppy_tpu_torch/confidence_intervals/) against the JAX package on
# the CPU, on the cases of tests/test_conf_int.py: each package runs its
# own farmer on the same scenario names, the same candidate and the same
# PDHG options (tol 1e-6, a 20,000-iteration cap: the drivers' default
# tol 1e-7 sits under the f32 floor, so the x* evaluation runs its
# 200,000-iteration cap, which the port's host loop pays ~30 s for).
# Estimates (G, s, z_n*, the MMW CI, the zhats, the sequential CI) agree
# to REL = 1e-4 of max(|E f(x̂)|, 1); seeds, sample sizes and iteration
# counts exactly.  program_from_cfg: None on opt-out, the audible
# fallback, and a provenance equal to the JAX package's.
import functools
import types

import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu.confidence_intervals import ciutils as jci
from mpisppy_tpu.confidence_intervals import mmw_ci as jmmw
from mpisppy_tpu.confidence_intervals import seqsampling as jseq
from mpisppy_tpu.confidence_intervals import zhat4xhat as jzhat
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.utils.config import Config as JConfig
from mpisppy_tpu_torch.confidence_intervals import ciutils as tci
from mpisppy_tpu_torch.confidence_intervals import mmw_ci as tmmw
from mpisppy_tpu_torch.confidence_intervals import seqsampling as tseq
from mpisppy_tpu_torch.confidence_intervals import zhat4xhat as tzhat
from mpisppy_tpu_torch.models import farmer as tfarmer
from mpisppy_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(1)

XHAT_STAR = np.array([170.0, 80.0, 250.0])   # farmer EF optimum
BAD = np.array([500.0, 0.0, 0.0])           # all wheat: clearly bad
REL = 1e-4
# the port's CI default (tol 1e-6, cap 20,000), which its MMW and
# sequential drivers always use; the JAX drivers get the same options
TOPTS = tci.DEFAULT_OPTS
TOL, CAP = TOPTS.tol, TOPTS.max_iters
JOPTS = jpdhg.PDHGOptions(tol=TOL, max_iters=CAP)
SCALE = 108390.0                            # |E f| of the farmer optimum


def _cfgs(num_scens, **kw):
    out = []
    for Config in (JConfig, TConfig):
        cfg = Config()
        cfg.quick_assign("num_scens", int, num_scens)
        for k, v in kw.items():
            cfg.quick_assign(k, type(v), v)
        out.append(cfg)
    return out


def _close(a, b, scale=SCALE):
    return abs(a - b) <= REL * max(abs(scale), 1.0)


@pytest.fixture
def jax_opts(monkeypatch):
    """The JAX drivers that take no options (MMW, seqsampling) call
    gap_estimators with the test's options."""
    monkeypatch.setattr(jci, "gap_estimators", functools.partial(
        jci.gap_estimators, opts=JOPTS))


def _estimates(xhat, start, n=12, ArRP=1):
    jcfg, tcfg = _cfgs(n)
    names = jfarmer.scenario_names_creator(n, start=start)
    j = jci.gap_estimators(xhat, jfarmer, names, jcfg, ArRP=ArRP, opts=JOPTS)
    t = tci.gap_estimators(xhat, tfarmer, names, tcfg, ArRP=ArRP,
                           opts=TOPTS, device="cpu")
    return j, t


def _same_estimate(j, t):
    assert set(j) == set(t)
    assert j["seed"] == t["seed"]
    for k in ("G", "s", "zn_star"):
        if k in j:
            assert _close(j[k], t[k]), (k, j[k], t[k])
    if "xstar" in j:
        np.testing.assert_allclose(t["xstar"], j["xstar"], rtol=0,
                                   atol=REL * np.abs(j["xstar"]).max())


def test_gap_estimator_near_zero_at_optimum():
    j, t = _estimates(XHAT_STAR, start=100)
    _same_estimate(j, t)
    assert 0.0 <= t["G"] <= 0.02 * SCALE and t["s"] >= 0.0
    assert t["seed"] == 112


def test_gap_estimator_positive_for_bad_xhat():
    j_bad, t_bad = _estimates(BAD, start=200)
    j_good, t_good = _estimates(XHAT_STAR, start=200)
    _same_estimate(j_bad, t_bad)
    _same_estimate(j_good, t_good)
    assert t_bad["G"] > t_good["G"] + 1000.0


def test_gap_estimator_arrp_pooling_and_its_error():
    j, t = _estimates(XHAT_STAR, start=300, ArRP=2)
    _same_estimate(j, t)
    assert set(t) == {"G", "s", "seed"} and t["seed"] == 312
    jcfg, tcfg = _cfgs(12)
    names = tfarmer.scenario_names_creator(12, start=300)
    with pytest.raises(ValueError, match="not a multiple of ArRP"):
        jci.gap_estimators(XHAT_STAR, jfarmer, names, jcfg, ArRP=5)
    with pytest.raises(ValueError, match="not a multiple of ArRP"):
        tci.gap_estimators(XHAT_STAR, tfarmer, names, tcfg, ArRP=5,
                           device="cpu")


def test_mmw_ci_matches_jax(jax_opts):
    jcfg, tcfg = _cfgs(6)
    j = jmmw.MMWConfidenceIntervals(jfarmer, jcfg, XHAT_STAR, num_batches=3,
                                    batch_size=6, start=400,
                                    verbose=False).run(0.95)
    t = tmmw.MMWConfidenceIntervals(tfarmer, tcfg, XHAT_STAR, num_batches=3,
                                    batch_size=6, start=400, verbose=False,
                                    device="cpu").run(0.95)
    assert set(t) == set(j) and t["gap_outer_bound"] == 0.0
    assert len(t["Glist"]) == 3
    for a, b in zip(j["Glist"], t["Glist"]):
        assert _close(a, b), (j["Glist"], t["Glist"])
    for k in ("gap_inner_bound", "Gbar", "std"):
        assert _close(j[k], t[k]), (k, j[k], t[k])
    assert t["gap_inner_bound"] >= t["Gbar"]
    with pytest.raises(RuntimeError, match="Start must be specified"):
        tmmw.MMWConfidenceIntervals(tfarmer, tcfg, XHAT_STAR, 2,
                                    device="cpu")


def test_zhat4xhat_two_stage(tmp_path):
    jcfg, tcfg = _cfgs(8)
    jz, js = jzhat.evaluate_sample_trees(XHAT_STAR, 3, jcfg, jfarmer,
                                         InitSeed=500, opts=JOPTS)
    tz, ts = tzhat.evaluate_sample_trees(XHAT_STAR, 3, tcfg, tfarmer,
                                         InitSeed=500, opts=TOPTS,
                                         device="cpu")
    assert tz.shape == (3,) and ts == js == 524
    assert all(_close(a, b) for a, b in zip(jz, tz)), (jz, tz)
    assert np.isfinite(tz).all() and (tz < 0).all()
    # the t-interval driver, x̂ read back from the npy file
    p = str(tmp_path / "xhat.npy")
    tci.write_xhat(XHAT_STAR, p)
    np.testing.assert_array_equal(tci.read_xhat(p), XHAT_STAR)
    jcfg.quick_assign("xhatpath", str, p)
    tcfg.quick_assign("xhatpath", str, p)
    jbar, jeps = jzhat.run_samples(jcfg, jfarmer, num_samples=2)
    tbar, teps = tzhat.run_samples(tcfg, tfarmer, num_samples=2,
                                   device="cpu")
    assert _close(jbar, tbar) and _close(jeps, teps), (jbar, tbar, jeps,
                                                       teps)


def _xhat_gen(farmer, ef_mod, **dev):
    def gen(scenario_names, **kw):
        ef = ef_mod.ExtensiveForm({"tol": TOL, "max_iters": 200_000},
                                  scenario_names, farmer.scenario_creator,
                                  {"num_scens": len(scenario_names)}, **dev)
        ef.solve_extensive_form()
        sol = ef.get_root_solution()
        return np.array([sol[f"x{i}"] for i in range(3)])
    return gen


def _seq(criterion, maxit, gens=None, **knobs):
    from mpisppy_tpu.algos import ef as jef
    from mpisppy_tpu_torch.algos import ef as tef
    jcfg, tcfg = _cfgs(10, **knobs)
    jgen, tgen = gens or (_xhat_gen(jfarmer, jef),
                          _xhat_gen(tfarmer, tef, device="cpu"))
    j = jseq.SeqSampling(jfarmer, jgen, jcfg,
                         stopping_criterion=criterion).run(maxit=maxit)
    t = tseq.SeqSampling(tfarmer, tgen, tcfg, stopping_criterion=criterion,
                         device="cpu").run(maxit=maxit)
    assert (t["T"], t["nk"], t["converged"]) == (j["T"], j["nk"],
                                                 j["converged"])
    assert t["CI"][0] == 0.0 and _close(j["CI"][1], t["CI"][1]), (j, t)
    assert _close(j["G"], t["G"]) and _close(j["s"], t["s"])
    np.testing.assert_allclose(t["Candidate_solution"],
                               j["Candidate_solution"], rtol=0,
                               atol=REL * 500.0)
    return t


@pytest.mark.parametrize("criterion,knobs", [
    ("BM", dict(BM_h=3.0, BM_hprime=0.1, BM_eps=50.0, BM_eps_prime=40.0,
                confidence_level=0.9)),
    ("BPL", dict(BPL_eps=2000.0, BPL_c0=10, confidence_level=0.9))])
def test_seq_sampling_terminates_as_jax(jax_opts, criterion, knobs):
    t = _seq(criterion, 8, **knobs)
    assert t["T"] <= 8
    assert len(t["Candidate_solution"]) == 3 and np.isfinite(t["CI"][1])


def test_seq_sampling_converged_flag(jax_opts):
    """An unmet stopping criterion at maxit is flagged in both."""
    bad = (lambda names, **kw: np.zeros(3))
    t = _seq("BM", 2, gens=(bad, bad), BM_h=1.75, BM_hprime=0.0,
             BM_eps=0.01, BM_eps_prime=1e-8, confidence_level=0.9)
    assert t["converged"] is False and t["T"] == 2


def test_sample_sizes_and_stopping_rules_match_jax():
    """The sample-size recursions and stopping rules, host arithmetic
    only: BM (q given and q None), BPL's growth, the stochastic size."""
    for knobs in (dict(), dict(BM_q=None), dict(BM_q=1.5, BM_p=0.3)):
        jcfg, tcfg = _cfgs(10, **{k: v for k, v in knobs.items()
                                  if v is not None})
        if "BM_q" in knobs and knobs["BM_q"] is None:
            jcfg.quick_assign("BM_q", float, None)
            tcfg.quick_assign("BM_q", float, None)
        j = jseq.SeqSampling(jfarmer, None, jcfg)
        t = tseq.SeqSampling(tfarmer, None, tcfg, device="cpu")
        for k in range(1, 6):
            assert t.bm_sampsize(k, 1.0, 2.0, 10) == j.bm_sampsize(
                k, 1.0, 2.0, 10)
    jcfg, tcfg = _cfgs(10, BPL_eps=3.0, BPL_c0=7, BPL_c1=3)
    j = jseq.SeqSampling(jfarmer, None, jcfg, stochastic_sampling=True,
                         stopping_criterion="BPL")
    t = tseq.SeqSampling(tfarmer, None, tcfg, stochastic_sampling=True,
                         stopping_criterion="BPL", device="cpu")
    for k, G, s, nk in ((1, None, None, None), (2, 5.0, 3.0, 50),
                        (3, 0.5, 2.0, 80)):
        assert t.sample_size(k, G, s, nk) == j.sample_size(k, G, s, nk)
        assert t.bpl_fsp_sampsize(k, G, s, nk) == j.bpl_fsp_sampsize(
            k, G, s, nk)
    for G, s, nk in ((1.0, 2.0, 30), (0.1, 0.1, 400)):
        assert t.bpl_stopping_criterion(G, s, nk) \
            == j.bpl_stopping_criterion(G, s, nk)
        assert t.bm_stopping_criterion(G, s, nk) \
            == j.bm_stopping_criterion(G, s, nk)
    for bad in (dict(stopping_criterion="XYZ"),
                dict(solving_type="EF_mstage")):
        with pytest.raises(RuntimeError):
            tseq.SeqSampling(tfarmer, None, tcfg, device="cpu", **bad)


def test_ciutils_helpers_match_jax():
    for n, stages in ((10, 2), (10, 3), (100, 4)):
        assert tci.branching_factors_from_numscens(n, stages) \
            == jci.branching_factors_from_numscens(n, stages)
    for n, ref in ((5, [2, 2]), (50, [2, 3]), (1000, [3, 3, 2])):
        assert tci.scalable_branching_factors(n, ref) \
            == jci.scalable_branching_factors(n, ref)
    for G, obj, rel in ((-1e-3, 100.0, True), (-5.0, 100.0, True),
                        (-1e-5, 0.5, False), (3.0, 10.0, True)):
        assert tci.correcting_numeric(G, obj, rel) \
            == jci.correcting_numeric(G, obj, rel)


def test_program_from_cfg_gate_fallback_and_provenance(capsys):
    from mpisppy_tpu.models import aircond as jaircond
    from mpisppy_tpu.models import sslp as jsslp
    from mpisppy_tpu.scengen import program as jprog
    from mpisppy_tpu_torch.confidence_intervals.confidence_config import (
        confidence_config,
    )
    from mpisppy_tpu_torch.models import aircond as taircond
    from mpisppy_tpu_torch.models import sslp as tsslp
    from mpisppy_tpu_torch.scengen import program as tprog
    jcfg, tcfg = _cfgs(4)
    # the library default is the host stream: None without the opt-in
    assert tprog.program_from_cfg(tsslp, tcfg, 4) is None
    # CI-configured runs opt in by default (confidence_config)
    confidence_config(tcfg)
    assert tcfg["use_scengen"] is True and tcfg["scengen_seed"] == 0
    jcfg.quick_assign("use_scengen", bool, True)
    for k, v in (("n_servers", 5), ("n_clients", 15),
                 ("sslp_lp_relax", True), ("scengen_seed", 7)):
        jcfg.quick_assign(k, type(v), v)
        tcfg.quick_assign(k, type(v), v)
    j = jprog.program_from_cfg(jsslp, jcfg, 4, start=20)
    t = tprog.program_from_cfg(tsslp, tcfg, 4, start=20)
    assert t.provenance() == j.provenance()
    assert t.provenance()["base_seed"] == 7
    # a module without a program: None, silently, as the JAX package
    no_program = types.SimpleNamespace(kw_creator=lambda cfg: {})
    assert tprog.program_from_cfg(no_program, tcfg, 4) is None
    # a program that cannot cover the sample (aircond replicates by seed,
    # not start): audible, then None
    capsys.readouterr()
    assert tprog.program_from_cfg(taircond, tcfg, 4, start=3,
                                  branching_factors=(2, 2)) is None
    assert jprog.program_from_cfg(jaircond, jcfg, 4, start=3,
                                  branching_factors=(2, 2)) is None
    err = capsys.readouterr().err
    assert "use_scengen requested" in err and "legacy host stream" in err


def test_gap_estimator_scengen_sample_matches_jax():
    """With use_scengen the sample comes from sslp's program: both
    packages draw the same scenarios (the provenance equal), and their
    estimates agree."""
    from mpisppy_tpu.models import sslp as jsslp
    from mpisppy_tpu_torch.models import sslp as tsslp
    jcfg, tcfg = _cfgs(4, use_scengen=True, n_servers=5, n_clients=15,
                       sslp_lp_relax=True)
    names = tsslp.scenario_names_creator(4, start=30)
    xhat = np.full(5, 0.5)
    j = jci.gap_estimators(xhat, jsslp, names, jcfg, opts=JOPTS)
    t = tci.gap_estimators(xhat, tsslp, names, tcfg, opts=TOPTS,
                           device="cpu")
    assert t["seed_provenance"] == j["seed_provenance"]
    scale = max(abs(j["zn_star"] + j["G"]), 1.0)
    for k in ("G", "s", "zn_star"):
        assert _close(j[k], t[k], scale), (k, j[k], t[k])


def test_sampled_ef_route():
    """gap_estimators solves a sampled EF as a batch of one problem where
    a window design takes it (pdhg_window.takes; on the CPU always, the
    plain version), else unbatched.  On an H100 (232,448 bytes of shared
    memory a block, 132 SMs) the dense sslp 15x45 EFs of 9 scenarios
    (660 x 6,345) and of 10 (735 x 7,050, past one streamed scenario's
    vectors) both take the split design: one problem over 264 blocks."""
    from mpisppy_tpu_torch.algos.ef import build_ef
    from mpisppy_tpu_torch.models import sslp as tsslp
    from mpisppy_tpu_torch.ops import boxqp, pdhg_window
    H100 = (232_448, 132)
    inst = tsslp.synthetic_instance(15, 45)
    shapes = {}
    for S in (9, 10):
        specs = [tsslp.scenario_creator(nm, instance=inst, num_scens=S,
                                        lp_relax=True)
                 for nm in tsslp.scenario_names_creator(S)]
        efp = build_ef(specs, device="cpu")
        one = boxqp.one_problem(efp.qp)
        assert pdhg_window.takes(one) and not pdhg_window.takes(efp.qp)
        shapes[S] = tuple(efp.qp.A.shape)
    assert shapes == {9: (660, 6345), 10: (735, 7050)}
    for S in (9, 10):
        assert pdhg_window.plan_window("f32", *shapes[S], 1, *H100) == \
            pdhg_window.WindowPlan("split", 264, 264, True)
    assert not pdhg_window.streamed_fits(*shapes[10], H100[0])
