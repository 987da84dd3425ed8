# Port parity: ELL sparse constraint matrices (ops/sparse.py) and the
# layers that carry them (from_specs, Ruiz, BoxQP products, the PDHG
# engine rule and window, the scenario gathers).
#
# Tolerances: the ELL builders' vals and cols are EXACT (the same numpy
# construction); products and norms 1e-6 relative to the largest entry
# (f32 sums over <= 13 terms in another order: A'y is a gather over the
# transposed pattern here, a scatter-add in JAX); Ruiz 1e-6 relative
# (f64 in both); five PDHG windows on uc S=4 1e-5 of the iterate scale.
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.ops import sparse as jsparse
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import xhat as txhat
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.models import uc as tuc
from mpisppy_tpu_torch.ops.boxqp import BoxQP
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.ops import pdhg_window
from mpisppy_tpu_torch.ops import sparse as tsparse

torch.set_num_threads(1)


def _rand_sparse(m, n, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    M = sps.random(m, n, density=density, random_state=rng,
                   data_rvs=lambda k: rng.normal(size=k))
    M = sps.lil_matrix(M)
    for i in range(m):
        if M.rows[i] == []:
            M[i, rng.integers(n)] = rng.normal()
    M[3, :] = 0.0           # one empty row: all of it padding
    return sps.csr_matrix(M)


def _batch_mats(seed=4):
    base = _rand_sparse(11, 13, seed=seed)
    mats = []
    for s in range(4):
        M = base.copy()
        M.data = M.data * (1.0 + 0.1 * s)
        mats.append(M)
    return mats


def _close(t, j, rtol=1e-6):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rtol * max(1.0, np.abs(j).max()))


def test_ell_from_scipy_matches_jax_exactly():
    M = _rand_sparse(17, 29)
    j, t = jsparse.ell_from_scipy(M, jnp.float32), tsparse.ell_from_scipy(M)
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    assert t.n == j.n == 29
    np.testing.assert_array_equal(t.toarray(), np.asarray(j.toarray()))


@pytest.mark.parametrize("case", ["values", "union", "shared"])
def test_ell_from_scipy_batch_matches_jax_exactly(case):
    """Batched values on one pattern, differing patterns padded onto
    their union, and value-equal matrices collapsed to a shared block."""
    if case == "values":
        mats = _batch_mats()
    elif case == "union":
        mats = [sps.csr_matrix(np.array([[1.0, 0.0, 3.0], [0.0, 2.0, 0.0]])),
                sps.csr_matrix(np.array([[0.0, 1.0, 0.0], [0.0, 2.0, 5.0]]))]
    else:
        mats = [_rand_sparse(9, 7, seed=2)] * 3
        mats = [m.copy() for m in mats]
    j = jsparse.ell_from_scipy_batch(mats, jnp.float32)
    t = tsparse.ell_from_scipy_batch(mats)
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    assert t.vals.ndim == (2 if case == "shared" else 3)


@pytest.mark.parametrize("batched", [False, True])
def test_ell_products_and_norms_match_jax(batched):
    if batched:
        mats = _batch_mats()
        j = jsparse.ell_from_scipy_batch(mats, jnp.float32)
        t = tsparse.ell_from_scipy_batch(mats)
    else:
        M = _rand_sparse(17, 29)
        j, t = jsparse.ell_from_scipy(M, jnp.float32), \
            tsparse.ell_from_scipy(M)
    m, n = t.m, t.n
    rng = np.random.default_rng(1)
    X = rng.normal(size=(4, n)).astype(np.float32)
    Y = rng.normal(size=(4, m)).astype(np.float32)
    _close(t.matvec(torch.as_tensor(X)), j.matvec(jnp.asarray(X)))
    _close(t.rmatvec(torch.as_tensor(Y)), j.rmatvec(jnp.asarray(Y)))
    _close(t.row_sqnorms(), j.row_sqnorms())
    _close(t.col_sqnorms(), j.col_sqnorms())
    dense = torch.as_tensor(t.toarray())              # (..., m, n)
    want = (dense.transpose(-1, -2) @ torch.as_tensor(Y)[..., None])[..., 0]
    _close(t.rmatvec(torch.as_tensor(Y)), want.numpy())


def test_transposed_pattern_leaves_row_padding_out():
    """Row padding (column 0, value 0, after a row's first slot) is not
    listed under column 0, so the transposed pattern is as wide as the
    busiest column; a nonzero there breaks the convention and raises."""
    t = tsparse.ell_from_scipy(_rand_sparse(17, 29))
    counts = np.bincount(t.cols.numpy()[t.vals.numpy() != 0], minlength=29)
    # + 1: the empty row's first slot is listed under column 0
    assert t.t_slots.shape == (29, int(counts.max()) + 1)
    bad = t.vals.clone()
    pad = (t.cols == 0) & (torch.arange(t.k)[None, :] > 0)
    bad[pad.nonzero()[0][0], pad.nonzero()[0][1]] = 1.0
    with pytest.raises(ValueError, match="column 0"):
        tsparse.EllMatrix(vals=bad, cols=t.cols, n=t.n)


@pytest.mark.parametrize("batched", [False, True])
def test_ruiz_scale_ell_matches_jax(batched):
    if batched:
        j = jsparse.ell_from_scipy_batch(_batch_mats(), jnp.float32)
    else:
        j = jsparse.ell_from_scipy(_rand_sparse(17, 29), jnp.float32)
    vals, cols = np.asarray(j.vals), np.asarray(j.cols)
    jv, jr, jc = jsparse.ruiz_scale_ell(vals, cols, j.n)
    tv, tr, tc = tsparse.ruiz_scale_ell(vals, cols.astype(np.int64), j.n)
    for a, b in ((tv, jv), (tr, jr), (tc, jc)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def _uc_batches(S=4):
    ji, ti = juc.synthetic_instance(10, 24), tuc.synthetic_instance(10, 24)
    names = tuc.scenario_names_creator(S)
    jb = jbatch.from_specs([juc.scenario_creator(nm, instance=ji,
                                                 num_scens=S)
                            for nm in names])
    tb = tbatch.from_specs([tuc.scenario_creator(nm, instance=ti,
                                                 num_scens=S)
                            for nm in names], device="cpu")
    return jb, tb


def test_uc_batch_matches_jax_exactly():
    """uc 10 gen x 24 h: one shared ELL A (m=1708, n=1008, k=11),
    Ruiz-scaled bit for bit as the JAX package scales it."""
    jb, tb = _uc_batches()
    assert isinstance(tb.qp.A, tsparse.EllMatrix)
    assert tb.qp.A.vals.shape == (1708, 11) and tb.qp.A.n == 1008
    np.testing.assert_array_equal(tb.qp.A.vals.numpy(),
                                  np.asarray(jb.qp.A.vals))
    np.testing.assert_array_equal(tb.qp.A.cols.numpy(),
                                  np.asarray(jb.qp.A.cols))
    for f in ("c", "q", "bl", "bu", "l", "u"):
        np.testing.assert_array_equal(getattr(tb.qp, f).numpy(),
                                      np.asarray(getattr(jb.qp, f)))
    np.testing.assert_array_equal(tb.d_col.numpy(), np.asarray(jb.d_col))


def test_uc_pdhg_windows_match_jax():
    """Five restart windows of the plain iteration over the ELL A, each
    package from its own cold state (its own norm estimate)."""
    jb, tb = _uc_batches()
    jo, to = jpdhg.PDHGOptions(tol=1e-6), tpdhg.PDHGOptions(tol=1e-6)
    jst = jpdhg.solve_fixed(jb.qp, 5, jo, jpdhg.init_state(jb.qp, jo))
    tst = tpdhg.solve_fixed(tb.qp, 5, to, tpdhg.init_state(tb.qp, to))
    for j, t in ((jst.x, tst.x), (jst.y, tst.y)):
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_ell_routes_to_the_plain_iteration(device_type):
    """An ELL batch, shared or with batched values, takes the plain
    iteration on either device and is outside the kernel's scope."""
    _, tb = _uc_batches()
    batched = dataclasses.replace(tb.qp, A=tb.qp.A.with_vals(
        tb.qp.A.vals.expand(4, -1, -1).contiguous()))
    for qp in (tb.qp, batched):
        assert not pdhg_window.supported(qp)
        assert tpdhg.window_engine(qp, device_type) == "plain"


@pytest.mark.parametrize("batched", [False, True])
def test_ell_gathers_by_field_layout_when_m_equals_S(batched):
    """m == S: a scenario gather must touch only a batched vals, never
    the (m, k) pattern; the (k·S) shuffle stack keeps a shared ELL
    shared and repeats a batched one."""
    mats = [_rand_sparse(6, 9, seed=s) for s in range(6)] if batched \
        else [_rand_sparse(6, 9)] * 6
    A = tsparse.ell_from_scipy_batch(mats) if batched \
        else tsparse.ell_from_scipy(mats[0])
    S = A.m
    qp = BoxQP(c=torch.zeros(S, 9), q=torch.zeros(S, 9), A=A,
                      bl=torch.zeros(S, 6), bu=torch.ones(S, 6),
                      l=torch.zeros(S, 9), u=torch.ones(S, 9))
    idx = torch.tensor([4, 1])
    sub = tfw._gather_qp(qp, idx)
    assert torch.equal(sub.A.cols, A.cols)
    if batched:
        assert torch.equal(sub.A.vals, A.vals[idx])
    else:
        assert sub.A is A
    y = torch.randn(2, 6, generator=torch.Generator().manual_seed(0))
    want = torch.stack([torch.as_tensor(mats[i].T.toarray(),
                                        dtype=torch.float32) @ y[r]
                        for r, i in enumerate(idx.tolist())])
    torch.testing.assert_close(sub.rmatvec(y), want, rtol=1e-6, atol=1e-6)


def test_fixed_stack_keeps_a_shared_ell_shared():
    _, tb = _uc_batches()
    N = tb.num_nonants
    cands = torch.zeros(3, N)
    qp = txhat.fixed_stack(tb, cands)
    assert qp.A is tb.qp.A
    assert qp.l.shape == (3 * tb.num_scenarios, tb.qp.n)


def test_ell_round_trips_through_convert():
    jb, _ = _uc_batches()
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    assert isinstance(tb.qp.A, tsparse.EllMatrix)
    np.testing.assert_array_equal(tb.qp.A.vals.numpy(),
                                  np.asarray(jb.qp.A.vals))


def test_skewed_transposed_pattern_is_chunked(monkeypatch):
    """A pattern with a few busy columns (an extensive form's first
    scenario, linked to all the others) is cut into chunks instead of
    padding every column to the busiest count: the slots stay within
    twice the entries plus a chunk per column, and A'y and the column
    norms equal the dense products and the unchunked pattern's
    (ROADMAP C12)."""
    import scipy.sparse as sps
    rng = np.random.default_rng(5)
    m, n = 400, 300
    M = sps.random(m, n, density=0.01, random_state=3, format="lil")
    M[:, 0] = rng.normal(size=(m, 1))          # two busy columns
    M[::2, 7] = rng.normal(size=(m // 2, 1))
    M = sps.csr_matrix(M)
    plain = tsparse.ell_from_scipy(M)
    assert plain.t_heavy is None
    monkeypatch.setattr(tsparse, "SKEW_MIN_SLOTS", 1)
    t = tsparse.ell_from_scipy(M)
    assert t.t_heavy is not None and set(t.t_heavy.tolist()) >= {0, 7}
    entries = int((t.vals != 0).sum())
    assert t.t_slots.numel() <= 2 * (entries + n) + t.t_slots.shape[1] * n
    assert t.t_slots.numel() < plain.t_slots.numel() / 4
    Y = torch.as_tensor(rng.normal(size=(3, m)).astype(np.float32))
    dense = torch.as_tensor(M.toarray().astype(np.float32))
    np.testing.assert_allclose(t.rmatvec(Y).numpy(), (Y @ dense).numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.rmatvec(Y).numpy(),
                               plain.rmatvec(Y).numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(t.col_sqnorms().numpy(),
                               plain.col_sqnorms().numpy(), rtol=1e-6)
    moved = t.to("cpu")
    assert torch.equal(moved.t_chunks, t.t_chunks)
