# Port parity: second-order-cone rows (mpisppy_tpu_torch/ops/cones.py and
# the cone branches of ops/boxqp.py, core/batch.py and convert.py) against
# the JAX package, on the CPU.  Inputs are made with numpy from a seed and
# handed to both.  Tolerances: 1e-6 absolute (projections and the cone
# residuals, all f32 with the block sums taken in another order) and 1e-6
# relative (KKT residuals); the scaled batches match bit for bit, since
# both packages Ruiz-scale the f32 problem in numpy f64.
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import ccopf as jccopf
from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu.ops import cones as jcones
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import lagrangian as tlag
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.models import ccopf as tccopf
from mpisppy_tpu_torch.ops import boxqp as tboxqp
from mpisppy_tpu_torch.ops import cones as tcones

torch.set_num_threads(1)

ATOL = 1e-6
M = 14
# ragged blocks in any row order, head first, with box rows between them
BLOCKS = [np.array([3, 0, 7]), np.array([5, 1, 2, 9, 13]),
          np.array([12, 4])]


def _specs():
    return (jcones.cone_spec(M, BLOCKS), tcones.cone_spec(M, BLOCKS))


def _rows(S=6, seed=0, scale=2.0):
    return np.random.default_rng(seed).normal(
        scale=scale, size=(S, M)).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_cone_spec_fields_match_jax():
    js, ts = _specs()
    for f in ("is_soc", "is_head", "seg"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert (ts.num_cones, ts.max_dim, ts.head_rows) == (
        js.num_cones, js.max_dim, js.head_rows)


def test_csr_view_is_head_first_in_any_row_order():
    _, ts = _specs()
    ptr, rows = ts.csr()
    assert ptr.dtype == torch.int32 and rows.dtype == torch.int32
    assert ptr.tolist() == [0, 3, 8, 10]
    for b, blk in enumerate(BLOCKS):
        got = rows[ptr[b]:ptr[b + 1]].tolist()
        assert got[0] == blk[0]
        assert sorted(got[1:]) == sorted(blk[1:].tolist())
    assert ts.csr() is ts.csr()  # cached


@pytest.mark.parametrize("fn", ["project_soc_rows", "project_polar_rows",
                                "dual_cone_residual_rows"])
def test_projections_match_jax(fn):
    js, ts = _specs()
    v = _rows()
    _close(getattr(tcones, fn)(ts, torch.as_tensor(v)),
           getattr(jcones, fn)(js, jnp.asarray(v)))


def test_dual_prox_and_primal_violation_match_jax():
    js, ts = _specs()
    rng = np.random.default_rng(1)
    w = _rows(seed=2)
    b = rng.normal(size=(6, M)).astype(np.float32)
    bl = b - np.where(np.asarray(js.is_soc), 0.0,
                      rng.uniform(0.1, 1.0, (6, M))).astype(np.float32)
    bu = b + np.where(np.asarray(js.is_soc), 0.0,
                      rng.uniform(0.1, 1.0, (6, M))).astype(np.float32)
    sigma = rng.uniform(0.2, 2.0, (6, 1)).astype(np.float32)
    _close(tcones.dual_prox(ts, *map(torch.as_tensor, (w, sigma, bl, bu))),
           jcones.dual_prox(js, *map(jnp.asarray, (w, sigma, bl, bu))))
    ax = _rows(seed=3)
    _close(tcones.primal_violation_rows(ts, torch.as_tensor(ax),
                                        torch.as_tensor(bl)),
           jcones.primal_violation_rows(js, jnp.asarray(ax),
                                        jnp.asarray(bl)))


def test_head_membership_matches_jax():
    js, ts = _specs()
    for C in (None, 8):
        for t, j in zip(tcones.head_membership(ts, C),
                        jcones.head_membership(js, C)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("blocks,match", [
    ([np.array([0])], "head"),
    ([np.array([0, 1, 1])], "duplicate"),
    ([np.array([0, 1]), np.array([1, 2])], "overlaps")])
def test_cone_spec_errors(blocks, match):
    with pytest.raises(ValueError, match=match):
        tcones.cone_spec(4, blocks)
    with pytest.raises(ValueError, match=match):
        jcones.cone_spec(4, blocks)


def test_soc_rows_must_store_the_shift_in_both_bounds():
    _, ts = _specs()
    bl = np.zeros(M)
    bu = np.zeros(M)
    bu[7] = 1.0   # a tail row of block 0
    with pytest.raises(ValueError, match=r"\[7\]"):
        tboxqp.make_boxqp(np.zeros(3), np.zeros((M, 3)), bl, bu,
                          np.zeros(3), np.ones(3), device="cpu", cones=ts)
    qp = tboxqp.make_boxqp(np.zeros(3), np.zeros((M, 3)), bl, bl,
                           np.zeros(3), np.ones(3), device="cpu", cones=ts)
    assert qp.cones is not None


def test_group_row_scales_matches_jax():
    js, ts = _specs()
    rmax = np.abs(_rows(seed=4)).astype(np.float64) + 0.1
    np.testing.assert_array_equal(tboxqp.group_row_scales(rmax, ts),
                                  jboxqp.group_row_scales(rmax, js))


def _soc_specs(mod, bfs):
    S = bfs[0] * bfs[1]
    return [mod.scenario_creator(nm, branching_factors=bfs, soc=True)
            for nm in mod.scenario_names_creator(S)]


def _assert_cones_equal(tspec, jspec):
    assert tspec is not None and jspec is not None
    for f in ("is_soc", "is_head", "seg"):
        np.testing.assert_array_equal(getattr(tspec, f).numpy(),
                                      np.asarray(getattr(jspec, f)))
    assert (tspec.num_cones, tspec.max_dim, tspec.head_rows) == (
        jspec.num_cones, jspec.max_dim, jspec.head_rows)


@pytest.fixture(scope="module", params=[(3, 1), (3, 3)],
                ids=["3x1", "3x3"])
def ccopf_pair(request):
    bfs = request.param
    jb = jbatch.from_specs(_soc_specs(jccopf, bfs),
                           tree=jccopf.make_tree(bfs))
    tb = tbatch.from_specs(_soc_specs(tccopf, bfs),
                           tree=tccopf.make_tree(bfs), device="cpu")
    return jb, tb


def test_from_specs_soc_matches_jax_bit_for_bit(ccopf_pair):
    jb, tb = ccopf_pair
    ja, ta = convert.arrays_of(jb), convert.arrays_of(tb)
    for k in ("c", "q", "A", "bl", "bu", "l", "u"):
        np.testing.assert_array_equal(ta["qp"][k], ja["qp"][k], err_msg=k)
    for k in ("d_col", "d_row", "d_non", "node_of_slot"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    _assert_cones_equal(tb.qp.cones, jb.qp.cones)
    assert tb.qp.cones.num_cones == 9


def _iterates(jb, seed=5):
    rng = np.random.default_rng(seed)
    S, n = np.asarray(jb.qp.c).shape
    m = np.asarray(jb.qp.A).shape[0]
    return (rng.normal(size=(S, n)).astype(np.float32),
            rng.normal(scale=3.0, size=(S, m)).astype(np.float32))


def test_kkt_residuals_with_cones_match_jax(ccopf_pair):
    jb, tb = ccopf_pair
    x, y = _iterates(jb)
    jres = jboxqp.kkt_residuals(jb.qp, jnp.asarray(x), jnp.asarray(y))
    tres = tboxqp.kkt_residuals(tb.qp, torch.as_tensor(x),
                                torch.as_tensor(y))
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    # the conic dual residual is folded in: a y off the polar cone shows
    rd_box = tboxqp.dual_residual(tb.qp, torch.as_tensor(x),
                                  torch.as_tensor(y)).amax(dim=-1)
    c_scale = 1.0 + tb.qp.c.abs().amax(dim=-1)
    assert torch.all(tres[1] > rd_box / c_scale)


def test_certificates_with_cones_match_jax(ccopf_pair):
    jb, tb = ccopf_pair
    x, y = _iterates(jb, seed=6)
    for fn in ("infeasibility_certificate", "unboundedness_certificate"):
        arg = y if fn.startswith("infeas") else x
        t = getattr(tboxqp, fn)(tb.qp, torch.as_tensor(arg), 1e-4)
        j = getattr(jboxqp, fn)(jb.qp, jnp.asarray(arg), 1e-4)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_conic_certificates_accept_conic_rays_like_jax():
    """A direction whose SOC blocks lie inside K is a recession ray; a
    polar dual ray is tested on its projection (JAX test_cones)."""
    spec_j = jcones.cone_spec(3, [np.arange(3)])
    spec_t = tcones.cone_spec(3, [np.arange(3)])
    A = np.eye(3)
    c = np.array([-1.0, 0.0, 0.0])
    args = (c, A, np.zeros(3), np.zeros(3), np.full(3, -np.inf),
            np.full(3, np.inf))
    jqp = jboxqp.make_boxqp(*args, cones=spec_j)
    tqp = tboxqp.make_boxqp(*args, device="cpu", cones=spec_t)
    d = np.array([1.0, 0.5, 0.5], np.float32)
    assert bool(tboxqp.unboundedness_certificate(tqp, torch.as_tensor(d)))
    assert bool(jboxqp.unboundedness_certificate(jqp, jnp.asarray(d)))


def test_convert_keeps_the_cone_partition(ccopf_pair):
    jb, _ = ccopf_pair
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    _assert_cones_equal(tb.qp.cones, jb.qp.cones)
    back = convert.arrays_of(tb)
    assert "_csr" not in back["qp"]["cones"]
    _assert_cones_equal(
        convert.cone_spec_from_arrays(back["qp"]["cones"], "cpu"),
        jb.qp.cones)
    plain = convert.boxqp_from_arrays(
        {k: v for k, v in convert.arrays_of(jb.qp).items() if k != "cones"},
        "cpu")
    assert plain.cones is None


def test_every_qp_rebuild_keeps_the_cones(ccopf_pair):
    """A dropped ConeSpec turns the SOC rows (bl = bu = 0) into equality
    rows: a different problem that still solves.  Every derived qp of
    the wheel's planes keeps it."""
    _, tb = ccopf_pair
    S, N = tb.num_scenarios, tb.num_nonants
    W = torch.ones((S, N))
    spec = tb.qp.cones
    scaled, _ = tboxqp.ruiz_scale(tb.qp, iters=2)
    derived = [
        scaled,
        tlag._lagrangian_qp(tb, W),
        tb.with_nonant_linear_quad(W, W),
        tb.with_fixed_nonants(torch.zeros((tb.tree.num_nodes, N))),
        tb.with_fixed_nonants(torch.zeros(N)),
        tfw._gather_qp(tb.qp, torch.tensor([0, S - 1])),
        tbatch.pad_to_multiple(tb, 4).qp,
    ]
    for qp in derived:
        assert qp.cones is spec
    fixed = tb.with_fixed_nonants(
        torch.arange(tb.tree.num_nodes * N, dtype=torch.float32)
        .reshape(tb.tree.num_nodes, N))
    # every scenario's nonants are fixed to its own tree nodes' values
    x_non = fixed.l[:, tb.nonant_idx] * tb.d_non
    expect = torch.gather(
        torch.arange(tb.tree.num_nodes * N, dtype=torch.float32)
        .reshape(tb.tree.num_nodes, N), 0, tb.node_of_slot)
    torch.testing.assert_close(x_non, expect)


def test_ruiz_scale_keeps_blocks_uniform(ccopf_pair):
    _, tb = ccopf_pair
    spec = tb.qp.cones
    d_row = tb.d_row.numpy()
    seg = spec.seg.numpy()
    for b in range(spec.num_cones):
        vals = d_row[..., seg == b]
        assert np.all(vals == vals[..., :1])
    assert dataclasses.replace(tb.qp).cones is spec
