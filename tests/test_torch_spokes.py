# Port parity: the inner-bound heuristics of algos/xhat.py and the
# classic spokes built on them.  The same batch (carried across with
# mpisppy_tpu_torch.convert) and the same per-scenario nonants go
# through the JAX functions and the port on the CPU, on
# farmer (per-scenario A, S=3) and on the sslp(5,15) LP relaxation
# (shared A, S=16).  Tolerances:
#   * slam candidates: equal (a max/min and a ceil/floor);
#   * evaluated values: 1e-4 relative (each solve stops at a relative KKT
#     residual of 1e-6, in f32, with sums in another order);
#   * feasibility flags and the compensation gate: equal (the
#     compensation itself to 1e-5 of the value: it is first order in
#     violations at the f32 noise floor).
# The k shuffle candidates run as one (k·S)-scenario batch in the port
# (xhat.fixed_stack), a vmap of k evaluations in the JAX package; each
# block must also match the port's own evaluation of its candidate
# alone to 1e-5 relative.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import xhat as jxhat
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import xhat as txhat
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)

VALUE_RTOL = 1e-4


def _farmer():
    return jbatch.from_specs([jfarmer.scenario_creator(nm, num_scens=3)
                              for nm in jfarmer.scenario_names_creator(3)])


def _sslp():
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    return jbatch.from_specs([
        jsslp.scenario_creator(nm, instance=inst, num_scens=16,
                               lp_relax=True)
        for nm in jsslp.scenario_names_creator(16)])


@pytest.fixture(scope="module", params=["farmer", "sslp"])
def model(request):
    """(JAX batch, port batch, per-scenario nonants as numpy): each
    scenario's own optimal nonants (PH's iter0 solves)."""
    jb = _farmer() if request.param == "farmer" else _sslp()
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    o = jpdhg.PDHGOptions()
    st = jpdhg.solve(jb.qp, o, jpdhg.init_state(jb.qp, o))
    return jb, tb, np.array(jb.nonants(st.x))



@pytest.mark.parametrize("sense_max", [True, False])
def test_slam_candidate_matches_jax(model, sense_max):
    jb, tb, x_non = model
    got = txhat.slam_candidate(tb, torch.as_tensor(x_non), sense_max)
    want = jxhat.slam_candidate(jb, jnp.asarray(x_non), sense_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sense_max", [True, False])
def test_slam_heuristic_matches_jax(model, sense_max):
    jb, tb, x_non = model
    t = txhat.slam_heuristic(tb, torch.as_tensor(x_non), sense_max)
    j = jxhat.slam_heuristic(jb, jnp.asarray(x_non), sense_max)
    assert bool(t.feasible) == bool(j.feasible)
    if bool(j.feasible):
        assert float(t.value) == pytest.approx(float(j.value),
                                               rel=VALUE_RTOL)


def test_xhat_shuffle_matches_jax(model):
    jb, tb, x_non = model
    ids = [2, 0, 1, 2] if jb.num_scenarios == 3 else [5, 11, 0, 7]
    tv, tf, tc, tcomp = txhat.xhat_shuffle(tb, torch.as_tensor(x_non), ids,
                                           4)
    jv, jf, jc, jcomp = jxhat.xhat_shuffle(jb, jnp.asarray(x_non),
                                           jnp.asarray(ids), 4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.numpy().any()
    np.testing.assert_allclose(tv.numpy()[tf.numpy()],
                               np.asarray(jv)[np.asarray(jf)],
                               rtol=VALUE_RTOL)
    # the compensation is first order in f32-noise-level violations: it
    # agrees to 1e-5 of the value, and both sides gate alike
    feas = tf.numpy()
    np.testing.assert_allclose(
        tcomp.numpy()[feas], np.asarray(jcomp)[feas],
        atol=1e-5 * float(np.abs(tv.numpy()[feas]).max()))
    np.testing.assert_array_equal(
        txhat.comp_tight_mask(tv.numpy(), tcomp.numpy()),
        jxhat.comp_tight_mask(np.asarray(jv), np.asarray(jcomp)))
    # each block of the (k·S) batch is its candidate's own evaluation
    for j in range(4):
        one = txhat._evaluate_core(tb, tc[j], tpdhg.PDHGOptions(), 1e-3)
        assert bool(one.feasible) == bool(tf[j])
        if bool(one.feasible):
            assert float(tv[j]) == pytest.approx(float(one.value), rel=1e-5)


def test_fixed_stack_layout(model):
    """Block j of the (k·S) batch is the batch fixed at candidate j: a
    shared A stays the one (m, n) matrix, a per-scenario A repeats."""
    _, tb, x_non = model
    cands = torch.as_tensor(x_non[[0, 1, 0]])
    qp = txhat.fixed_stack(tb, cands)
    S = tb.num_scenarios
    assert qp.c.shape[0] == 3 * S
    assert qp.A.ndim == tb.qp.A.ndim
    if tb.qp.A.ndim == 2:
        assert qp.A is tb.qp.A
    for j in range(3):
        one = tb.with_fixed_nonants(cands[j])
        blk = slice(j * S, (j + 1) * S)
        for f in ("l", "u", "c", "q"):
            assert torch.equal(getattr(qp, f)[blk], getattr(one, f))
        if qp.A.ndim == 3:
            assert torch.equal(qp.A[blk], one.A)
        for f in ("bl", "bu"):
            t = getattr(qp, f)
            assert torch.equal(t[blk] if t.ndim == 2 else t, getattr(one, f))


def test_xhat_eval_matches_jax(model):
    jb, tb, x_non = model
    cands = [x_non[0], x_non[1]]
    t = txhat.XhatEval(tb)
    j = jxhat.XhatEval(jb)
    tval, tbest = t.calculate_incumbent(cands)
    jval, jbest = j.calculate_incumbent(cands)
    assert tbest == jbest
    assert tval == pytest.approx(jval, rel=VALUE_RTOL)
    assert t.evaluate(cands[1]) == pytest.approx(j.evaluate(cands[1]),
                                                 rel=VALUE_RTOL)


def test_xhat_xbar_matches_jax(model):
    jb, tb, x_non = model
    xbar = x_non.mean(axis=0, keepdims=True)
    t = txhat.xhat_xbar(tb, torch.as_tensor(xbar))
    j = jxhat.xhat_xbar(jb, jnp.asarray(xbar))
    assert bool(t.feasible) == bool(j.feasible)
    assert float(t.value) == pytest.approx(float(j.value), rel=VALUE_RTOL)


class _Opt:
    def __init__(self, batch):
        self.batch = batch


@pytest.mark.parametrize("cls", [
    tspoke.LagrangianOuterBound, tspoke.XhatXbarInnerBound,
    tspoke.XhatShuffleInnerBound, tspoke.SlamMaxHeuristic,
    tspoke.SlamMinHeuristic])
def test_classic_spokes_publish_against_a_snapshot(model, cls):
    """update() against a hub snapshot at W = 0 leaves a result in
    _pending and harvest() folds it: the Lagrangian spoke publishes the
    wait-and-see bound E[min f_s] (the JAX package's L(0), 1e-4
    relative); an inner spoke publishes, with its candidate, exactly
    when the JAX package finds its candidate feasible, and a value above
    that bound."""
    from mpisppy_tpu.algos import lagrangian as jlag
    jb, tb, x_non = model
    xn = torch.as_tensor(x_non)
    xbar = xn.mean(dim=0, keepdim=True)
    payload = {"W": torch.zeros_like(xn), "nonants": xn,
               "xbar_scen": xbar.expand_as(xn), "xbar_nodes": xbar,
               "iter": 1}
    sp = cls(_Opt(tb), {"k": 2})
    assert sp.harvest() is None
    sp.update(payload)
    b = sp.harvest()
    L0 = float(jlag.lagrangian_bound(jb, jnp.zeros(x_non.shape)).bound)
    if cls is tspoke.LagrangianOuterBound:
        assert b == pytest.approx(L0, rel=VALUE_RTOL)
        return
    jx = jnp.asarray(x_non)
    if cls is tspoke.XhatXbarInnerBound:
        ref = jxhat.xhat_xbar(jb, jnp.asarray(xbar.numpy()))
        feasible = bool(ref.feasible)
    elif cls is tspoke.XhatShuffleInnerBound:
        ids = [int(i) for i in sp._order[:2]]
        feasible = bool(np.asarray(jxhat.xhat_shuffle(
            jb, jx, jnp.asarray(ids), 2)[1]).any())
    else:
        feasible = bool(jxhat.slam_heuristic(
            jb, jx, cls is tspoke.SlamMaxHeuristic).feasible)
    if not feasible:
        assert b is None
        return
    assert b is not None and b >= L0 - VALUE_RTOL * abs(L0)
    assert sp.best_xhat.shape[-1] == tb.num_nonants


class _NamedOpt(_Opt):
    def __init__(self, batch, names):
        super().__init__(batch)
        self.scenario_names = names


def _payloads(jb, tb, x_non, it):
    """The same hub snapshot for both packages (W = rho (x - x̄), a valid
    multiplier: its node mean is zero)."""
    xbar = x_non.mean(axis=0, keepdims=True)
    W = 2.0 * (x_non - xbar)
    arrs = dict(W=W, nonants=x_non, xbar_scen=np.broadcast_to(
        xbar, x_non.shape).copy(), xbar_nodes=xbar)
    jp = {k: jnp.asarray(v) for k, v in arrs.items()}
    tp = {k: torch.as_tensor(v) for k, v in arrs.items()}
    jp["iter"] = tp["iter"] = it
    return jp, tp


SPOKES_OF_THIS_SLICE = [
    ("LagrangerOuterBound", {"rho": 2.0}),
    ("SubgradientOuterBound", {"rho": 2.0, "n_windows": 20}),
    ("PhOuterBound", {"rho": 2.0, "n_windows": 8}),
    ("ReducedCostsSpoke", {}),
    ("XhatLooperInnerBound", {"scen_limit": 2}),
    ("XhatSpecificInnerBound", {"scenario_ids": [2, 1]}),
    ("XhatLShapedInnerBound", {}),
]


@pytest.mark.parametrize("name,options", SPOKES_OF_THIS_SLICE,
                         ids=[s[0] for s in SPOKES_OF_THIS_SLICE])
def test_spokes_of_this_slice_match_jax(model, name, options):
    """Two syncs of each spoke against the same snapshots: the harvested
    bound agrees with the JAX spoke's to 1e-4 relative (both None when
    neither certifies or finds a feasible candidate); the reduced-costs
    spoke's per-scenario reduced costs agree to 1e-4 of their scale and
    its expected ones are finite (consensus at a bound) alike."""
    from mpisppy_tpu.cylinders import spoke as jspoke
    jb, tb, x_non = model
    names = [f"scen{i}" for i in range(tb.num_scenarios)]
    o = dict(options, pdhg_opts=None)
    del o["pdhg_opts"]
    js = getattr(jspoke, name)(_NamedOpt(jb, names), dict(o))
    ts = getattr(tspoke, name)(_NamedOpt(tb, names), dict(o))
    for it in (1, 2):
        jp, tp = _payloads(jb, tb, x_non, it)
        js.update(jp)
        ts.update(tp)
        jbnd, tbnd = js.harvest(), ts.harvest()
        assert (jbnd is None) == (tbnd is None), (it, jbnd, tbnd)
        if jbnd is not None:
            assert tbnd == pytest.approx(jbnd, rel=VALUE_RTOL), it
    if name == "ReducedCostsSpoke":
        assert ts.new_rc == js.new_rc
        if js.rc_scenario is not None:
            np.testing.assert_allclose(
                ts.rc_scenario, js.rc_scenario, rtol=0,
                atol=1e-4 * max(1.0, np.abs(js.rc_scenario).max()))
            fin = np.isfinite(js.rc_global)
            np.testing.assert_array_equal(np.isfinite(ts.rc_global), fin)
            np.testing.assert_allclose(ts.rc_global[fin],
                                       js.rc_global[fin], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("name", ["EFOuterBound", "EFXhatInnerBound"])
def test_ef_spokes_match_jax_on_a_multistage_tree(name):
    """The EF spokes on ccopf (2,2) --soc (a three-stage conic tree):
    three syncs from the same x̄, bounds within 1e-4 relative."""
    from mpisppy_tpu.cylinders import spoke as jspoke
    from mpisppy_tpu.models import ccopf as jm
    jtree = jm.make_tree((2, 2))
    specs = [jm.scenario_creator(nm, branching_factors=(2, 2), soc=True)
             for nm in jm.scenario_names_creator(4)]
    jb = jbatch.from_specs(specs, tree=jtree)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    o = jpdhg.PDHGOptions()
    st = jpdhg.solve(jb.qp, o)
    xbar_nodes = np.asarray(jb.node_average(jb.nonants(st.x))[1])
    from mpisppy_tpu_torch.models import ccopf as tm
    tspecs = [tm.scenario_creator(nm, branching_factors=(2, 2), soc=True)
              for nm in tm.scenario_names_creator(4)]
    js = getattr(jspoke, name)(_Opt(jb), {"specs": specs, "tree": jtree})
    ts = getattr(tspoke, name)(_Opt(tb), {"specs": tspecs,
                                          "tree": tm.make_tree((2, 2))})
    for _ in range(3):
        js.update({"xbar_nodes": jnp.asarray(xbar_nodes)})
        ts.update({"xbar_nodes": torch.tensor(xbar_nodes)})
        jbnd, tbnd = js.harvest(), ts.harvest()
        assert (jbnd is None) == (tbnd is None)
        if jbnd is not None:
            assert tbnd == pytest.approx(jbnd, rel=VALUE_RTOL)
    assert ts.bound is not None
