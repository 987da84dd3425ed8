# Port parity: the PDHG restart window.  The port's run_window on CPU
# tensors is the plain version of the CUDA kernel (csrc/pdhg_window.cu);
# it is held here against the JAX package's Pallas kernel run in
# interpret mode (mpisppy_tpu/ops/pdhg_pallas.py::run_window), the
# function the CUDA kernel replaces.  Both engines of the Pallas kernel
# (single-buffer grid, double-buffered pipeline) are covered, in f32 and
# in the bf16x3 split mode (on the CPU only the interpret path computes
# true bf16x3: XLA treats Precision.HIGH as HIGHEST there).  Tolerance:
# atol/rtol 1e-4 on x and y after one 40-iteration window, as in
# tests/test_pdhg_pallas.py — both sides run f32 arithmetic, with the
# matvec sums taken in another order.  The dense shared-A model shapes
# (hydro 7x13, sizes 62x150, usar 18x147) sit where an f32 window's
# rounding floor can exceed that: hydro's reservoir rows and sizes'
# columns of 10^4 put both sides up to ~1e-3 from exact arithmetic.  A
# field of theirs that misses the tolerance must lie no farther from the
# same window run in f64 than twice the Pallas kernel does, plus the
# tolerance.
#
# The conic window (the ccopf --soc batch, SOC dual prox on 36 of its 69
# rows) is held to tests/test_cones.py's tolerances in f32: 2e-6 on the
# iterates, 5e-6 on the window sums, after 8 iterations from zero sums.
# In bf16x3 a value whose last bits differ between the two sides splits
# into other bf16 parts and moves its dropped lo*lo term by ~2^-16, so
# that mode keeps the box-row cases' 1e-4.
import dataclasses

import numpy as np
import pytest
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import ccopf as jccopf
from mpisppy_tpu.models import hydro as jhydro
from mpisppy_tpu.models import sizes as jsizes
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.models import usar as jusar
from mpisppy_tpu.ops import cones as jcones
from mpisppy_tpu.ops import pdhg_pallas
from mpisppy_tpu.ops.boxqp import make_boxqp as jmake_boxqp
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.ops import pdhg_window

torch.set_num_threads(1)

N_ITERS = 40
TOL = 1e-4


def _random_lp(S=13, m=7, n=11, seed=0):
    """Shared dense A, per-scenario c and row bounds; two rows are
    one-sided (+-inf bounds), as on sslp's capacity rows."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x_feas = rng.uniform(0.2, 0.8, size=(S, n))
    b = np.einsum("mn,sn->sm", A, x_feas)
    bl = b - rng.uniform(0.5, 1.5, size=(S, m))
    bu = b + rng.uniform(0.5, 1.5, size=(S, m))
    bl[:, 0] = -np.inf
    bu[:, 1] = np.inf
    return jmake_boxqp(c=rng.normal(size=(S, n)), A=A, bl=bl, bu=bu,
                       l=np.zeros((S, n)), u=np.ones((S, n)))


def _sslp_qp(S=13):
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=S,
                                    lp_relax=True)
             for nm in jsslp.scenario_names_creator(S)]
    return jbatch.from_specs(specs).qp


MODEL_SHAPES = ("hydro", "sizes", "usar")


def _model_qp(model, S=13):
    """A dense shared-A model batch of the JAX package: hydro's 7x13 (a
    (13, 1) tree), sizes' 62x150, usar's 18x147 (LP relaxation)."""
    if model == "hydro":
        specs = [jhydro.scenario_creator(nm, branching_factors=(S, 1))
                 for nm in jhydro.scenario_names_creator(S)]
        return jbatch.from_specs(specs, tree=jhydro.make_tree((S, 1))).qp
    if model == "sizes":
        specs = [jsizes.scenario_creator(nm, scenario_count=S, lp_relax=True)
                 for nm in jsizes.scenario_names_creator(S)]
    else:
        inst = jusar.generate_instance()
        specs = [jusar.scenario_creator(nm, instance=inst, num_scens=S,
                                        lp_relax=True)
                 for nm in jusar.scenario_names_creator(S)]
    return jbatch.from_specs(specs).qp


def _f64_window(tqp, targs):
    """The plain window run in f64 (f64 products in every mode) on the
    same inputs: the window's arithmetic up to f64 rounding."""
    q64 = dataclasses.replace(tqp, **{f: getattr(tqp, f).double() for f in
                                      ("A", "c", "q", "l", "u", "bl", "bu")})
    rest = [t.double() if t.is_floating_point() else t for t in targs]
    return [t.numpy() for t in pdhg_window.run_window_reference(
        q64, *rest, N_ITERS)]


def _window_inputs(jqp, seed=0):
    """A box-feasible primal, a nonzero dual, window sums, per-scenario
    step sizes and a done mask with three frozen lanes."""
    rng = np.random.default_rng(seed)
    c = np.asarray(jqp.c)
    S, n = c.shape
    m = np.asarray(jqp.A).shape[0]
    l = np.broadcast_to(np.asarray(jqp.l), (S, n))  # noqa: E741
    u = np.broadcast_to(np.asarray(jqp.u), (S, n))
    x = np.clip(rng.uniform(-0.5, 1.5, (S, n)), l, u).astype(np.float32)
    y = rng.normal(scale=0.1, size=(S, m)).astype(np.float32)
    xs = rng.normal(size=(S, n)).astype(np.float32)
    ys = rng.normal(size=(S, m)).astype(np.float32)
    L = np.linalg.norm(np.asarray(jqp.A), 2)
    omega = rng.uniform(0.5, 2.0, S)
    tau = (0.99 * omega / L).astype(np.float32)
    sigma = (0.99 / (omega * L)).astype(np.float32)
    done = np.zeros(S, bool)
    done[[1, 6, S - 1]] = True
    return x, y, xs, ys, tau, sigma, done


@pytest.mark.parametrize("problem,precision,pipeline", [
    ("random", None, False), ("random", "bf16x3", True),
    ("sslp", None, True), ("sslp", "bf16x3", False),
    ("hydro", None, False), ("hydro", "bf16x3", True),
    ("sizes", None, True), ("sizes", "bf16x3", True),
    ("usar", None, False), ("usar", "bf16x3", True)])
def test_plain_window_matches_pallas_interpret(problem, precision, pipeline):
    jqp = {"random": _random_lp, "sslp": _sslp_qp}.get(
        problem, lambda: _model_qp(problem))()
    args = _window_inputs(jqp)
    jout = pdhg_pallas.run_window(jqp, *args, N_ITERS, tile_s=4,
                                  precision=precision, pipeline=pipeline,
                                  interpret=True)
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), device="cpu")
    targs = [torch.as_tensor(a) for a in args]
    tout = pdhg_window.run_window(tqp, *targs, N_ITERS, precision=precision)
    exact = _f64_window(tqp, targs) if problem in MODEL_SHAPES else None
    for k, (name, j, t) in enumerate(zip(("x", "y", "x_sum", "y_sum"),
                                         jout, tout)):
        j = np.asarray(j)
        assert np.all(np.isfinite(t.numpy())), name
        tol = TOL if name in ("x", "y") else N_ITERS * TOL
        if exact is not None and not np.allclose(t.numpy(), j, atol=tol,
                                                 rtol=tol):
            # the model shapes' f32 rounding floor: no farther from the
            # f64 window than twice the Pallas kernel is, plus tol
            e = exact[k]
            assert np.abs(t.numpy() - e).max() <= \
                2.0 * np.abs(j - e).max() + tol, name
            continue
        np.testing.assert_allclose(t.numpy(), j, atol=tol, rtol=tol,
                                   err_msg=name)
    # frozen lanes come back bit-unchanged; their sums accumulate
    done = args[-1]
    x, y, xs, ys = args[:4]
    np.testing.assert_array_equal(tout[0].numpy()[done], x[done])
    np.testing.assert_array_equal(tout[1].numpy()[done], y[done])
    if problem in MODEL_SHAPES:
        # their sums cancel more: held to the f32 adds, one an iteration
        acc = xs[done].copy()
        for _ in range(N_ITERS):
            acc = acc + x[done]
        np.testing.assert_array_equal(tout[2].numpy()[done], acc)
    else:
        np.testing.assert_allclose(tout[2].numpy()[done],
                                   xs[done] + N_ITERS * x[done], rtol=1e-5)


def test_bf16x3_differs_from_f32_but_stays_close():
    """The bf16x3 mode really splits (its result is not the f32 one) and
    stays within the split's ~1e-5 relative error per matvec."""
    jqp = _sslp_qp()
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), device="cpu")
    targs = [torch.as_tensor(a) for a in _window_inputs(jqp)]
    f32 = pdhg_window.run_window(tqp, *targs, N_ITERS)
    b3 = pdhg_window.run_window(tqp, *targs, N_ITERS, precision="bf16x3")
    assert not torch.equal(f32[1], b3[1])
    torch.testing.assert_close(b3[0], f32[0], atol=1e-3, rtol=1e-3)



def _ccopf_soc_qp():
    specs = [jccopf.scenario_creator(nm, soc=True)
             for nm in jccopf.scenario_names_creator(9)]
    return jbatch.from_specs(specs, tree=jccopf.make_tree((3, 3))).qp


@pytest.mark.parametrize("precision,pipeline", [
    (None, True), (None, False), ("bf16x3", True), ("bf16x3", False)])
def test_plain_conic_window_matches_pallas_interpret(precision, pipeline):
    jqp = _ccopf_soc_qp()
    assert jqp.cones is not None
    x, y, _, _, tau, sigma, done = _window_inputs(jqp, seed=3)
    # start from a polar-cone dual so frozen lanes stay dual-feasible
    y = np.array(jcones.project_polar_rows(jqp.cones, y), np.float32)
    xs, ys = np.zeros_like(x), np.zeros_like(y)
    n_iters = 8
    jout = pdhg_pallas.run_window(jqp, x, y, xs, ys, tau, sigma, done,
                                  n_iters, tile_s=4, precision=precision,
                                  pipeline=pipeline, interpret=True)
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), device="cpu")
    assert tqp.cones is not None
    tout = pdhg_window.run_window(
        tqp, *[torch.as_tensor(a) for a in (x, y, xs, ys, tau, sigma, done)],
        n_iters, precision=precision)
    for name, j, t in zip(("x", "y", "x_sum", "y_sum"), jout, tout):
        if precision is None:
            tol = dict(atol=2e-6 if name in ("x", "y") else 5e-6, rtol=0)
        else:
            tol = dict(atol=TOL, rtol=TOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **tol)
    np.testing.assert_array_equal(tout[0].numpy()[done], x[done])
    np.testing.assert_array_equal(tout[1].numpy()[done], y[done])
    # the conic prox lands every live iterate in the polar cone
    dcr = jcones.dual_cone_residual_rows(jqp.cones, tout[1].numpy())
    assert float(np.max(dcr)) <= 1e-6
