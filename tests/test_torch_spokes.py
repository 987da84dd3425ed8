# Port parity: the inner-bound heuristics of algos/xhat.py and the
# classic spokes built on them.  The same batch (carried across with
# mpisppy_tpu_torch.convert), the same per-scenario nonants and the JAX
# norm estimate go through the JAX functions and the port on the CPU, on
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
from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import xhat as txhat
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)

VALUE_RTOL = 1e-4


def jax_norm_estimate(p, iters=30, generator=None):
    arrs = convert.arrays_of(p)
    jp = jboxqp.BoxQP(**{k: jnp.asarray(arrs[k])
                         for k in ("c", "q", "A", "bl", "bu", "l", "u")})
    return torch.as_tensor(np.array(jpdhg.estimate_norm(jp, iters)))


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


@pytest.fixture(autouse=True)
def _jax_norm(monkeypatch):
    monkeypatch.setattr(tpdhg, "estimate_norm", jax_norm_estimate)


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
