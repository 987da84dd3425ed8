# Port parity: the restarted PDHG solver.  The cases of test_pdhg.py and
# test_status.py go through the JAX solver and through the port, both
# from the SAME initial state (carried across with
# mpisppy_tpu_torch.convert, so the power-iteration norm estimate is the
# JAX one), and must agree on statuses, iterates and the dispatch_cap
# chunking.  Iterates are compared at 1e-4 (absolute, on scaled
# variables of order one): f32 arithmetic with sums in another order,
# and on shared-A batches the port runs the window kernel's hoisted form
# of the iteration.
import dataclasses

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.ops import boxqp as tboxqp
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)

def _opts(**kw):
    return jpdhg.PDHGOptions(**kw), tpdhg.PDHGOptions(**kw)


def _solve_both(jp, kw, fixed_windows=None):
    jo, to = _opts(**kw)
    jst0 = jpdhg.init_state(jp, jo)
    tp = convert.boxqp_from_arrays(convert.arrays_of(jp), device="cpu")
    tst0 = convert.pdhg_state_from_arrays(convert.arrays_of(jst0), "cpu")
    if fixed_windows is None:
        return jpdhg.solve(jp, jo, jst0), tpdhg.solve(tp, to, tst0)
    return (jpdhg.solve_fixed(jp, fixed_windows, jo, jst0),
            tpdhg.solve_fixed(tp, fixed_windows, to, tst0))


def _random_lp(rng, n=20, m=12, two_sided=False):
    A = rng.normal(size=(m, n))
    x0 = rng.uniform(0.5, 2.0, size=n)
    bu = A @ x0 + rng.uniform(0.1, 1.0, size=m)
    bl = A @ x0 - rng.uniform(3.0, 6.0, size=m) if two_sided \
        else np.full(m, -np.inf)
    c = rng.normal(size=n)
    return jboxqp.make_boxqp(c, A, bl, bu, np.zeros(n), np.full(n, 5.0))


def _shared_a_batch(S=5, m=7, n=11, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x_feas = rng.uniform(0.2, 0.8, size=(S, n))
    b = np.einsum("mn,sn->sm", A, x_feas)
    bl = b - rng.uniform(0.5, 1.5, size=(S, m))
    bl[:, 0] = -np.inf
    return jboxqp.make_boxqp(c=rng.normal(size=(S, n)), A=A, bl=bl,
                             bu=b + rng.uniform(0.5, 1.5, size=(S, m)),
                             l=np.zeros((S, n)), u=np.ones((S, n)))


def _assert_states_close(jst, tst, atol=1e-4):
    np.testing.assert_array_equal(tst.status.numpy(), np.asarray(jst.status))
    np.testing.assert_array_equal(tst.done.numpy(), np.asarray(jst.done))
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), atol=atol)
    np.testing.assert_allclose(tst.y.numpy(), np.asarray(jst.y),
                               atol=atol * max(1.0, np.abs(jst.y).max()))


@pytest.mark.parametrize("two_sided", [False, True])
def test_solve_single_lp_matches_jax_and_scipy(two_sided):
    rng = np.random.default_rng(0)
    prob = _random_lp(rng, two_sided=two_sided)
    scaled, sc = jboxqp.ruiz_scale(prob)
    jst, tst = _solve_both(scaled, dict(tol=1e-6, max_iters=40_000))
    _assert_states_close(jst, tst)
    assert bool(tst.done) and int(tst.status) == tpdhg.OPTIMAL
    A, bu = np.asarray(prob.A), np.asarray(prob.bu)
    A_ub, b_ub = [A], [bu]
    if two_sided:
        A_ub.append(-A)
        b_ub.append(-np.asarray(prob.bl))
    res = linprog(np.asarray(prob.c), A_ub=np.vstack(A_ub),
                  b_ub=np.concatenate(b_ub), bounds=[(0, 5)] * A.shape[1],
                  method="highs")
    obj = float(np.asarray(prob.c) @ (tst.x.numpy() * sc.d_col))
    assert obj == pytest.approx(res.fun, abs=2e-3, rel=2e-4)


def test_solve_shared_a_batch_matches_jax():
    """A dense shared-A batch: the port's windows run the kernel's plain
    version (hoisted iteration), the JAX solver its XLA loop."""
    jp = _shared_a_batch()
    jst, tst = _solve_both(jp, dict(tol=1e-6, max_iters=20_000))
    assert bool(tst.done.all())
    _assert_states_close(jst, tst)
    np.testing.assert_allclose(
        tboxqp.objective(convert.boxqp_from_arrays(
            convert.arrays_of(jp), "cpu"), tst.x).numpy(),
        np.asarray(jboxqp.objective(jp, jst.x)), rtol=1e-5, atol=1e-5)


def test_solve_fixed_matches_jax():
    jp = _shared_a_batch(S=6, seed=3)
    jst, tst = _solve_both(jp, dict(tol=0.0, restart_period=40),
                           fixed_windows=5)
    assert tst.k == int(jst.k) == 200
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), atol=1e-4)
    # omega is a ratio of restart displacement norms: its relative
    # sensitivity to summation order is far above that of the iterates
    np.testing.assert_allclose(tst.omega.numpy(), np.asarray(jst.omega),
                               rtol=1e-2)


def test_statuses_infeasible_in_batch_and_unbounded_match_jax():
    A = np.array([[[1.0, 0.0], [0.0, 1.0]]] * 3)
    bl = np.array([[-np.inf, -np.inf], [2.0, -np.inf], [-np.inf, -np.inf]])
    bu = np.array([[1.0, 1.0], [np.inf, 1.0], [1.5, 1.0]])
    jp = jboxqp.make_boxqp(c=np.array([[1.0, 1.0]] * 3), A=A, bl=bl, bu=bu,
                           l=np.zeros((3, 2)), u=np.ones((3, 2)))
    kw = dict(tol=1e-6, max_iters=20_000, detect_infeas=True)
    jst, tst = _solve_both(jp, kw)
    assert list(tst.status.numpy()) == [tpdhg.OPTIMAL, tpdhg.INFEASIBLE,
                                        tpdhg.OPTIMAL]
    np.testing.assert_array_equal(tst.status.numpy(), np.asarray(jst.status))
    np.testing.assert_allclose(tst.x.numpy()[0], [0.0, 0.0], atol=1e-4)

    jp = jboxqp.make_boxqp(c=[-1.0, 0.0], A=[[0.0, 1.0]], bl=[-np.inf],
                           bu=[1.0], l=[0.0, 0.0], u=[np.inf, 1.0])
    jst, tst = _solve_both(jp, kw)
    assert int(tst.status) == int(jst.status) == tpdhg.UNBOUNDED


def test_certificates_match_jax():
    p = dict(c=[0.0], A=[[1.0], [1.0]], bl=[-np.inf, 1.0], bu=[0.0, np.inf],
             l=[-10.0], u=[10.0])
    y = np.asarray([1.0, -1.0], np.float32)
    for bu0, expect in ((0.0, True), (2.0, False)):
        p["bu"] = [bu0, np.inf]
        tp = tboxqp.make_boxqp(**p, device="cpu")
        got = bool(tboxqp.infeasibility_certificate(tp, torch.as_tensor(y)))
        assert got == expect == bool(jboxqp.infeasibility_certificate(
            jboxqp.make_boxqp(**p), y))
    for u0, expect in ((np.inf, True), (5.0, False)):
        kw = dict(c=[-1.0], A=[[0.0]], bl=[-np.inf], bu=[1.0], l=[0.0],
                  u=[u0])
        d = np.asarray([1.0], np.float32)
        got = bool(tboxqp.unboundedness_certificate(
            tboxqp.make_boxqp(**kw, device="cpu"), torch.as_tensor(d)))
        assert got == expect == bool(jboxqp.unboundedness_certificate(
            jboxqp.make_boxqp(**kw), d))


def test_auto_chunked_dispatch_matches_jax(monkeypatch):
    """A budget above dispatch_cap runs as capped chunks, at the same
    iteration counts as the JAX solver's capped dispatches."""
    f = lambda v: np.asarray(v, np.float32)  # noqa: E731
    jp = jboxqp.BoxQP(c=f([1.0]), q=f([0.0]), A=f([[1.0]]), bl=f([2.0]),
                      bu=f([np.inf]), l=f([0.0]), u=f([1.0]))
    calls = {"jax": [], "torch": []}
    for name, mod in (("jax", jpdhg), ("torch", tpdhg)):
        real = mod._dispatch_capped

        def spy(p, opts, st, _real=real, _log=calls[name]):
            out = _real(p, opts, st)
            _log.append(int(out.k))
            return out
        monkeypatch.setattr(mod, "_dispatch_capped", spy)
    kw = dict(tol=1e-30, max_iters=2_000, dispatch_cap=400,
              restart_period=40, detect_infeas=False)
    jst, tst = _solve_both(jp, kw)
    assert len(calls["torch"]) >= 2
    assert calls["torch"] == calls["jax"]
    assert tst.k == int(jst.k) <= 2_000
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), atol=1e-5)


def test_lane_guard_quarantines_a_poisoned_lane():
    """A NaN lane is reset (and counted) by the lane guard exactly as in
    the JAX solver; the healthy lanes are untouched."""
    jp = _shared_a_batch(S=4, seed=5)
    jo, to = _opts(tol=1e-6, restart_period=40)
    jo = dataclasses.replace(jo, lane_guard=True)
    to = dataclasses.replace(to, lane_guard=True)
    jst0 = jpdhg.init_state(jp, jo)
    x = np.asarray(jst0.x).copy()
    x[2, 0] = np.nan
    jst0 = dataclasses.replace(jst0, x=x)
    tst0 = convert.pdhg_state_from_arrays(convert.arrays_of(jst0), "cpu")
    tp = convert.boxqp_from_arrays(convert.arrays_of(jp), "cpu")
    jst = jpdhg.solve_fixed(jp, 3, jo, jst0)
    tst = tpdhg.solve_fixed(tp, 3, to, tst0)
    np.testing.assert_array_equal(tst.guard_resets.numpy(),
                                  np.asarray(jst.guard_resets))
    assert int(tst.guard_resets[2]) >= 1 and np.isfinite(tst.x.numpy()).all()
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), atol=1e-4)


class _Ell:
    """Stand-in for an ELL constraint matrix (vals, cols), the JAX
    package's ops/sparse.py layout the port does not have yet."""

    def __init__(self):
        self.vals = torch.ones((3, 2))
        self.cols = torch.zeros((3, 2), dtype=torch.int64)


def _engine_cases():
    shared = convert.boxqp_from_arrays(convert.arrays_of(_shared_a_batch()),
                                       "cpu")
    per_scen = dataclasses.replace(
        shared, A=shared.A.expand(shared.c.shape[0], -1, -1).contiguous())
    return {"shared": shared, "per_scenario": per_scen,
            "ell": dataclasses.replace(shared, A=_Ell())}


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("structure,engine", [
    ("shared", "kernel"), ("per_scenario", "plain"), ("ell", None)])
def test_window_engine_rule(structure, engine, device_type):
    """The JAX package's engine rule, on the batch's structure alone:
    one dense shared A takes the window kernel (its plain version on the
    CPU), a per-scenario dense A the plain batched iteration, on either
    device; ELL is not ported and raises naming its queue item."""
    p = _engine_cases()[structure]
    if engine is None:
        with pytest.raises(NotImplementedError, match="item 5"):
            tpdhg.window_engine(p, device_type)
    else:
        assert tpdhg.window_engine(p, device_type) == engine


def test_farmer_per_scenario_window_matches_jax():
    """farmer's yields enter A, so its batch carries an (S, m, n) A and
    runs the plain batched iteration; three windows from the JAX initial
    state land within 2e-6 of the iterate scale of the JAX _window (its
    XLA fori_loop): f32 rounding in another summation order, ~5e-8 of
    the scale per iteration."""
    from mpisppy_tpu.core import batch as jbatch
    from mpisppy_tpu.models import farmer as jfarmer
    specs = [jfarmer.scenario_creator(nm, num_scens=3)
             for nm in jfarmer.scenario_names_creator(3)]
    jb = jbatch.from_specs(specs)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    assert tb.qp.A.ndim == 3
    assert tpdhg.window_engine(tb.qp, "cpu") == "plain"
    jst, tst = _solve_both(jb.qp, dict(tol=0.0), fixed_windows=3)
    for j, t in ((jst.x, tst.x), (jst.y, tst.y)):
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=2e-6 * scale)
    np.testing.assert_allclose(tst.score.numpy(), np.asarray(jst.score),
                               rtol=1e-3)
