# Port parity: seeded scenario synthesis (mpisppy_tpu_torch/scengen) and
# the window kernel's in-kernel synthesis, against the JAX package's
# scengen (tests/test_scengen.py is the JAX side's own contract).
#
# The contract is bit identity, so most comparisons here are exact:
# the port's threefry against jax.random; the port's programs against
# the JAX programs (materialized batches leaf by leaf, the template
# scaling included); host materialization (from_specs with scaling=)
# against device synthesis (materialize); a program's declarative
# row_draws against its sampler; the synth window's plain version
# against the plain window on the realized batch; and a VirtualBatch
# wheel against the same wheel on the materialized batch.  Where the two
# packages run different arithmetic the tolerances are those the other
# port tests state: the window against the Pallas kernel in interpret
# mode at tests/test_torch_pdhg_window.py's f32 TOL (1e-4 on x, y and
# n_iters * TOL on the window sums), and the wheel's bounds against the
# JAX wheel's at tests/test_torch_wheel.py's 1e-3 relative.
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu import scengen as jscengen
from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.ops import pdhg_pallas
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu_torch import convert, scengen
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.cylinders.hub import PHHub as TPHHub
from mpisppy_tpu_torch.models import farmer as tfarmer
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.ops import cones as tcones
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.ops import pdhg_window
from mpisppy_tpu_torch.scengen import random as rnd
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner

torch.set_num_threads(1)

TOL = 1e-4          # tests/test_torch_pdhg_window.py's f32 window TOL
WHEEL_REL = 1e-3    # tests/test_torch_wheel.py's bound agreement
SEEDS = (0, 1, 7, 123_456, 2**31 - 1)


def _np(v):
    return np.asarray(v)


# --------------------------------------------------------------------------
# threefry2x32 against jax.random
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_matches_jax_random(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rnd.prng_key(seed)
    assert np.array_equal(_np(jk).astype(np.int64), tk.numpy())
    for d in (0, 1, 5, 99_999, 2**31 - 1):
        assert np.array_equal(_np(jax.random.fold_in(jk, d)).astype(np.int64),
                              rnd.fold_in(tk, d).numpy())
    for shape in ((1,), (8,), (45,), (3, 4), (2, 3)):
        assert np.array_equal(_np(jax.random.bits(jk, shape)).astype(np.int64),
                              rnd.random_bits(tk, shape).numpy())
        ju = _np(jax.random.uniform(jk, shape, jnp.float32))
        tu = rnd.uniform(tk, shape).numpy()
        assert tu.dtype == np.float32 and np.array_equal(ju, tu)
    # Bernoulli(p) is uniform < p, as jax.random.bernoulli draws it
    jb = _np(jax.random.bernoulli(jk, 0.5, (16,)))
    assert np.array_equal(jb, (rnd.uniform(tk, (16,)) < 0.5).numpy())
    # a batch of keys draws what vmap over the scenario index draws
    idx = np.array([0, 3, 17, 2**31 - 1])
    jv = _np(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jk, i), (3, 5)))(jnp.asarray(idx, jnp.int32)))
    tv = rnd.uniform(rnd.fold_in(tk, torch.as_tensor(idx)), (3, 5)).numpy()
    assert np.array_equal(jv, tv)


@pytest.mark.parametrize("seed", (2, 11))
def test_advance_rekey_matches_jax(seed):
    """ScenarioProgram.advance(step): the base key folded to `step`
    (absolute), equal to the JAX program's, with identical draws."""
    jp = jsslp.scenario_program(4, seed=seed, n_servers=3, n_clients=8)
    tp = tsslp.scenario_program(4, seed=seed, n_servers=3, n_clients=8)
    assert tp.advance(0) is tp
    tp2 = tp.advance(3)
    assert tp2.advance(3) is tp2 and tp2.advance(5).step == 5
    assert np.array_equal(
        _np(jax.random.fold_in(jax.random.PRNGKey(seed), 3)).astype(np.int64),
        tp2.base_key().numpy())
    assert np.array_equal(_np(jp.advance(3).base_key()).astype(np.int64),
                          tp2.base_key().numpy())
    assert np.array_equal(jp.advance(3).spec_at(1).bl, tp2.spec_at(1).bl)
    assert not np.array_equal(tp.spec_at(1).bl, tp2.spec_at(1).bl) \
        or not np.array_equal(tp.spec_at(2).bl, tp2.spec_at(2).bl)
    assert tp2.provenance() == {**jp.advance(3).provenance()}
    assert "step" not in tp.provenance()


# --------------------------------------------------------------------------
# programs and batches
# --------------------------------------------------------------------------
def _programs(name):
    if name == "sslp":
        kw = dict(seed=1, n_servers=3, n_clients=8)
        return (jsslp.scenario_program(5, **kw),
                tsslp.scenario_program(5, **kw))
    return (jfarmer.scenario_program(6, seed=3),
            tfarmer.scenario_program(6, seed=3))


def _leaves(obj, prefix=""):
    """(path, numpy array) of every array leaf of a batch's fields."""
    arrs = convert.arrays_of(obj)

    def walk(d, path):
        if isinstance(d, dict):
            for k, v in d.items():
                if k != "tree":
                    yield from walk(v, f"{path}.{k}")
        elif d is not None and not isinstance(d, (int, tuple)):
            yield path, np.asarray(d)
    return dict(walk(arrs, prefix))


def _assert_same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        assert x.shape == y.shape, k
        if x.dtype != y.dtype:       # int32 (JAX) vs int64 (port) indices
            assert x.dtype.kind == y.dtype.kind == "i", k
            x = x.astype(y.dtype)
        assert np.array_equal(x, y, equal_nan=True), k


@pytest.mark.parametrize("model", ["sslp", "farmer"])
def test_programs_materialize_bit_identically(model):
    """Port materialize == port from_specs(to_specs(), scaling=) ==
    JAX scengen.materialize, leaf by leaf, the scaling included."""
    jp, tp = _programs(model)
    assert np.array_equal(jp.scaling.d_row, tp.scaling.d_row)
    assert np.array_equal(jp.scaling.d_col, tp.scaling.d_col)
    tm = scengen.materialize(tp, device="cpu")
    th = tbatch.from_specs(tp.to_specs(), tree=tp.tree,
                           scaling=tp.scaling, device="cpu")
    _assert_same_leaves(tm, th)
    _assert_same_leaves(jscengen.materialize(jp), tm)
    assert tm.num_real == th.num_real == tp.num_scenarios
    for js_, ts_ in zip(jp.to_specs(), tp.to_specs()):
        for f in ("c", "A", "bl", "bu", "l", "u"):
            assert np.array_equal(getattr(js_, f), getattr(ts_, f))


def test_start_window_shifts_draws():
    """Draw s depends only on (base_seed, start + s)."""
    p0 = tfarmer.scenario_program(4, seed=3, start=0)
    p2 = tfarmer.scenario_program(4, seed=3, start=2)
    assert np.array_equal(p0.spec_at(2).A, p2.spec_at(2).A)
    assert np.array_equal(p0.spec_at(3).A, p2.spec_at(3).A)
    assert not np.array_equal(p0.spec_at(2).A, p0.spec_at(3).A)
    j2 = jfarmer.scenario_program(4, seed=3, start=2)
    assert np.array_equal(j2.spec_at(3).A, p2.spec_at(3).A)
    assert p2.provenance() == j2.provenance()


def test_virtual_batch_surface_pad_and_repartition():
    prog = tfarmer.scenario_program(64, seed=0)
    vb = scengen.virtual_batch(prog, device="cpu")
    assert vb.num_scenarios == 64 and vb.num_real == 64
    assert vb.qp.c.shape == (64, 12) and vb.qp.c.dtype == torch.float32
    assert vb.device.type == "cpu" and vb.tree.num_nodes == 1
    lb, ub = vb.nonant_box()
    jlb, jub = jscengen.virtual_batch(
        jfarmer.scenario_program(64, seed=0)).nonant_box()
    assert np.array_equal(lb, jlb) and np.array_equal(ub, jub)
    assert lb.shape == (3,) and np.all(ub > lb)
    assert vb.persistent_bytes() < vb.materialized_bytes() / 4
    b = vb.realize()
    x = torch.rand(b.qp.c.shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(vb.nonants(x), b.nonants(x))
    assert torch.equal(vb.expectation(x.sum(-1)), b.expectation(x.sum(-1)))
    # pad rows carry probability zero and clone the last real scenario
    vbp = scengen.virtual_batch(prog, pad_to=48, device="cpu")
    assert vbp.num_scenarios == 96 and vbp.num_real == 64
    bp = vbp.realize()
    assert float(vbp.p.sum()) == pytest.approx(1.0, abs=1e-6)
    assert float(vbp.p[64:].sum()) == 0.0
    assert torch.equal(bp.qp.A[64:], bp.qp.A[63].expand(32, 7, 12))
    assert torch.equal(bp.qp.A[:64], b.qp.A)
    # repartition: same draws, pad rows re-derived with probability zero
    vbr = scengen.repartition(vbp, 5)
    assert vbr.num_scenarios == 65 and torch.equal(vbr.p[:64], vb.p)
    assert float(vbr.p[64]) == 0.0
    assert torch.equal(vbr.realize().qp.A[64], b.qp.A[63])
    # the sslp program's batch keeps one shared A
    svb = scengen.virtual_batch(tsslp.scenario_program(
        1000, seed=0, n_servers=3, n_clients=8), device="cpu")
    assert svb.qp.A.shape == (11, 30) and svb.qp.bl.shape == (1000, 11)
    assert svb.persistent_bytes() < svb.materialized_bytes() / 4


def test_program_surface():
    prog = tsslp.scenario_program(7, seed=2, start=3, n_servers=3,
                                  n_clients=8)
    assert scengen.has_program(tsslp) and scengen.has_program(tfarmer)
    assert np.array_equal(prog.indices(), np.arange(3, 10))
    assert prog.provenance()["scheme"] == "threefry2x32/fold_in"
    p2 = scengen.program_for(tsslp, 7, seed=2, start=3, n_servers=3,
                             n_clients=8)
    assert np.array_equal(p2.spec_at(4).bl, prog.spec_at(4).bl)
    assert scengen.program_for(object(), 3) is None
    jprog = jsslp.scenario_program(7, seed=2, start=3, n_servers=3,
                                   n_clients=8)
    assert scengen.estimate_materialized_bytes(prog) == \
        jscengen.program.estimate_materialized_bytes(jprog)
    with pytest.raises(ValueError, match="unknown varying"):
        dataclasses.replace(prog, varying=("bl", "W"))


@pytest.mark.parametrize("seed,start", [(0, 0), (4, 17), (2**31 - 1, 5)])
def test_row_draws_equal_sampler(seed, start):
    """The sslp sampler is its row_draws rule over the template, and that
    rule draws the JAX sslp sampler's bits at the full 5x25 width."""
    prog = tsslp.scenario_program(50, seed=seed, start=start)
    jprog = jsslp.scenario_program(50, seed=seed, start=start)
    rd = prog.row_draws
    assert set(prog.varying) == set(rd.fields)
    idx = prog.indices()
    fields = scengen.sample_fields(prog, torch.as_tensor(idx))
    jfields = jscengen.program.sample_fields(jprog,
                                             jnp.asarray(idx, jnp.int32))
    drawn = rd.draw(prog.base_key(), torch.as_tensor(idx))
    assert drawn.dtype == torch.float32
    for name in rd.fields:
        assert np.array_equal(fields[name].numpy(), _np(jfields[name]))
        assert torch.equal(fields[name][:, rd.row0:rd.row0 + rd.count],
                           drawn)


# --------------------------------------------------------------------------
# the synth window (plain version on the CPU)
# --------------------------------------------------------------------------
def _synth_window_inputs(S, n, m):
    """tests/test_scengen.py::test_pallas_tile_synth_bit_matches_dma_window's
    inputs."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(S, n)).astype(np.float32)
    y = rng.normal(size=(S, m)).astype(np.float32)
    zx, zy = np.zeros_like(x), np.zeros_like(y)
    tau = np.full((S,), 0.05, np.float32)
    sig = np.full((S,), 0.05, np.float32)
    done = np.zeros((S,), bool)
    return x, y, zx, zy, tau, sig, done


@pytest.fixture(scope="module")
def sslp200():
    kw = dict(seed=4, n_servers=3, n_clients=8, lp_relax=True)
    return jsslp.scenario_program(200, **kw), tsslp.scenario_program(200, **kw)


@pytest.mark.parametrize("precision", [None, "bf16x3"])
def test_synth_plain_window_equals_realized_window(sslp200, precision):
    _, prog = sslp200
    vb = scengen.virtual_batch(prog, device="cpu")
    bm = vb.realize()
    S, n = bm.qp.c.shape
    args = [torch.as_tensor(a) for a in
            _synth_window_inputs(S, n, bm.qp.bl.shape[-1])]
    args[6][[3, 150]] = True        # two frozen lanes
    ref = pdhg_window.run_window_reference(bm.qp, *args, 4,
                                           precision=precision)
    qp_proxy, ts = scengen.window_inputs(vb)
    assert qp_proxy.bl.ndim == 1 and qp_proxy.c.stride(0) == 0
    out = pdhg_window.run_window(qp_proxy, *args, 4, precision=precision,
                                 synth=ts)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)
    assert torch.equal(ts.synthesize(qp_proxy, S).bl, bm.qp.bl)


def test_synth_plain_window_matches_pallas_interpret(sslp200):
    jprog, prog = sslp200
    args = _synth_window_inputs(200, *tsslp.scenario_program(
        1, n_servers=3, n_clients=8).template["A"].shape[::-1])
    qp_j, ts_j = jscengen.window_inputs(jscengen.virtual_batch(jprog))
    jout = pdhg_pallas.run_window(qp_j, *args, n_iters=4, pipeline=True,
                                  interpret=True, synth=ts_j)
    qp_t, ts_t = scengen.window_inputs(
        scengen.virtual_batch(prog, device="cpu"))
    tout = pdhg_window.run_window(qp_t, *[torch.as_tensor(a) for a in args],
                                  4, synth=ts_t)
    for name, j, t in zip(("x", "y", "x_sum", "y_sum"), jout, tout):
        tol = TOL if name in ("x", "y") else 4 * TOL
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol,
                                   rtol=tol, err_msg=name)


def test_window_inputs_and_synth_reject_what_the_kernel_cannot_draw():
    with pytest.raises(ValueError, match="shared dense"):
        scengen.window_inputs(scengen.virtual_batch(
            tfarmer.scenario_program(6, seed=0), device="cpu"))
    prog = tsslp.scenario_program(8, seed=0, n_servers=3, n_clients=4)
    with pytest.raises(ValueError, match="row_draws"):
        scengen.window_inputs(scengen.virtual_batch(
            dataclasses.replace(prog, row_draws=None), device="cpu"))
    qp, ts = scengen.window_inputs(scengen.virtual_batch(prog, device="cpu"))
    m = qp.A.shape[0]
    conic = dataclasses.replace(qp, cones=tcones.cone_spec(
        m, [np.array([0, 1])]))
    x = torch.zeros((8, qp.n))
    y = torch.zeros((8, m))
    sv = torch.ones(8)
    with pytest.raises(ValueError, match="conic"):
        pdhg_window.run_window(conic, x, y, x, y, sv, sv,
                               torch.zeros(8, dtype=torch.bool), 2, synth=ts)


# --------------------------------------------------------------------------
# the VirtualBatch wheel
# --------------------------------------------------------------------------
def test_virtual_wheel_steps_publish_the_materialized_scalars():
    """The fused wheel's steps on a VirtualBatch publish exactly the
    scalars of the materialized batch (tests/test_scengen.py:98-123)."""
    prog = tfarmer.scenario_program(12, seed=7)
    vb = scengen.virtual_batch(prog, device="cpu")
    bm = scengen.materialize(prog, device="cpu")
    opts = tph.PHOptions(subproblem_windows=2, iter0_windows=30,
                         pdhg=tpdhg.PDHGOptions(tol=1e-6, restart_period=40))
    wopts = tfw.FusedWheelOptions(lag_windows=2, xhat_windows=2,
                                  split_dispatch=False)
    rho = torch.ones(vb.num_nonants)
    sv, tbv, cv = tfw.fused_iter0(vb, rho, opts, wopts)
    sm, tbm, cm = tfw.fused_iter0(bm, rho, opts, wopts)
    assert float(tbv) == float(tbm) and bool(cv) == bool(cm)
    for _ in range(3):
        sv = tfw.fused_iterk(vb, sv, opts, wopts)
        sm = tfw.fused_iterk(bm, sm, opts, wopts)
    assert torch.equal(sv.scalars, sm.scalars)
    assert float(tph.ph_eobjective(vb, sv.ph)) == float(
        tph.ph_eobjective(bm, sm.ph))


def _wheel(ph_mod, pdhg_mod, fw_mod, spoke_mod, hub_cls, spinner, batch,
           split):
    """The farmer fused wheel to a 0.1% gap: at the tighter target both
    packages' bounds close on the optimum, so their agreement measures
    the bounds, not where two f32 trajectories first cross 1%."""
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=150,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg_mod.PDHGOptions(tol=1e-7))
    hub = {"hub_class": hub_cls,
           "hub_kwargs": {"options": {"rel_gap": 1e-3}},
           "opt_class": fw_mod.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw_mod.FusedWheelOptions(
                              split_dispatch=split)}}
    spokes = [{"spoke_class": spoke_mod.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke_mod.FusedXhatXbarInnerBound,
               "opt_kwargs": {"options": {}}}]
    return spinner(hub, spokes).spin()


@pytest.fixture(scope="module")
def jax_farmer_wheel():
    jws = _wheel(jph, jpdhg, jfw, jspoke, JPHHub, JWheelSpinner,
                 jscengen.virtual_batch(jfarmer.scenario_program(12, seed=7)),
                 None)
    return jws.BestOuterBound, jws.BestInnerBound


@pytest.mark.parametrize("split", [False, True])
def test_virtual_wheel_matches_jax_and_materialized(split, jax_farmer_wheel):
    prog = tfarmer.scenario_program(12, seed=7)
    tws = _wheel(tph, tpdhg, tfw, tspoke, TPHHub, TWheelSpinner,
                 scengen.virtual_batch(prog, device="cpu"), split)
    outer, inner = tws.BestOuterBound, tws.BestInnerBound
    assert np.isfinite(outer) and np.isfinite(inner) and outer <= inner
    assert (inner - outer) / abs(inner) <= 1e-3 + 1e-6
    for t, j in zip((outer, inner), jax_farmer_wheel):
        assert abs(t - j) <= WHEEL_REL * abs(j), (t, j)
    mws = _wheel(tph, tpdhg, tfw, tspoke, TPHHub, TWheelSpinner,
                 scengen.materialize(prog, device="cpu"), split)
    assert (mws.BestOuterBound, mws.BestInnerBound) == (outer, inner)
    assert mws.spcomm._iter == tws.spcomm._iter
