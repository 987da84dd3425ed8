###############################################################################
# ELL sparse constraint matrices (port of mpisppy_tpu/ops/sparse.py).
#
# uc-class constraint matrices are sparse (balance, ramp and min-up/down
# rows touch a handful of columns).  ELLPACK stores a fixed
# k = max nonzeros per row: vals (..., m, k) and cols (m, k), the
# pattern shared across the batch and only the values batched.
#
#   A @ x  = sum_k vals * x[cols]
#   A' @ y = sum_t vals[t_slots] * y[t_rows]
#
# A' y is a gather too, over the transposed pattern: t_slots (n, kt)
# lists each column's nonzeros as flat slot indices into vals (row * k +
# position), t_rows their rows.  A scatter-add (index_add_) computes the
# same function, but on CUDA its atomics sum in an order that changes
# from run to run; the gather sums each column in the same order on
# every run and every device.  Column padding points at slot m * k, a
# zero appended to vals at call time, and at row 0.
#
# A product is a gather, a multiply and a sum over an (S, m, k)
# intermediate.  With values shared by the batch and an intermediate of
# at least BAG_MIN_ELEMENTS, it is one embedding_bag over the transposed
# iterate instead (bags = the rows of A or of A', per-sample weights =
# the values), which reads the batch's rows of x' in place of the
# intermediate (750 MB per product on uc at S=10,000) but costs more
# launches, which is what a small batch pays for.  Row padding entries
# point at column 0 with value 0, so no mask is needed in A @ x.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


def transpose_pattern(cols: np.ndarray, n: int):
    """(t_slots, t_rows) of an ELL pattern, numpy int64 (n, kt): the
    flat slot and the row of each column's entries in slot order, padded
    with slot m * k and row 0.  Each row's columns ascend (the
    constructors sort them), so a column-0 slot after a row's first is
    row padding (value 0) and is left out: listing every padding slot
    under column 0 would make kt as large as the padding."""
    cols = np.asarray(cols, np.int64)
    m, k = cols.shape
    keep = ((cols != 0) | (np.arange(k)[None, :] == 0)).reshape(-1)
    slots = np.nonzero(keep)[0]
    flat = cols.reshape(-1)[slots]
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n)
    kt = max(1, int(counts.max()) if flat.size else 1)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(flat.size) - np.repeat(start, counts)
    t_slots = np.full((n, kt), m * k, np.int64)
    t_slots[flat[order], pos] = slots[order]
    t_rows = np.where(t_slots < m * k, t_slots // max(k, 1), 0)
    return t_slots, t_rows


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK matrix of logical shape (..., m, n).

    vals:    (..., m, k) nonzero values (an optional leading batch axis).
    cols:    (m, k) int64 column indices, shared across the batch.
    n:       number of columns.
    t_slots, t_rows: the transposed pattern (see transpose_pattern),
             derived from cols when not given."""

    vals: Tensor
    cols: Tensor
    n: int
    t_slots: Tensor | None = None
    t_rows: Tensor | None = None

    def __post_init__(self):
        if self.t_slots is None or self.t_rows is None:
            cols = self.cols.cpu().numpy()
            pad = (cols == 0) & (np.arange(cols.shape[-1])[None, :] > 0)
            if pad.any() and np.any(self.vals.detach().cpu().numpy()[
                    ..., pad] != 0):
                raise ValueError(
                    "EllMatrix: a nonzero at column 0 after a row's first "
                    "slot (each row's columns must ascend, padding last)")
            ts, tr = transpose_pattern(cols, self.n)
            dev = self.cols.device
            object.__setattr__(self, "t_slots", torch.as_tensor(ts).to(dev))
            object.__setattr__(self, "t_rows", torch.as_tensor(tr).to(dev))

    @property
    def shape(self) -> tuple:
        """The LOGICAL (..., m, n) shape."""
        return tuple(self.vals.shape[:-1]) + (self.n,)

    @property
    def m(self) -> int:
        return self.vals.shape[-2]

    @property
    def k(self) -> int:
        return self.vals.shape[-1]

    def to(self, device) -> "EllMatrix":
        return EllMatrix(vals=self.vals.to(device), cols=self.cols.to(device),
                         n=self.n, t_slots=self.t_slots.to(device),
                         t_rows=self.t_rows.to(device))

    def with_vals(self, vals: Tensor) -> "EllMatrix":
        """The same pattern with other values."""
        return dataclasses.replace(self, vals=vals)

    # -- products ---------------------------------------------------------
    def matvec(self, x: Tensor) -> Tensor:
        """A @ x, batch-aware (f32; no iteration precision applies)."""
        return _product(self.cols, self.vals, x)

    def _t_vals(self) -> Tensor:
        """vals on the transposed pattern, (..., n, kt)."""
        flat = self.vals.reshape(self.vals.shape[:-2] + (-1,))
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))],
                         dim=-1)
        return flat[..., self.t_slots]

    def rmatvec(self, y: Tensor) -> Tensor:
        """A' @ y over the transposed pattern, batch-aware."""
        return _product(self.t_rows, self._t_vals(), y)

    def toarray(self) -> np.ndarray:
        """Dense (..., m, n) numpy copy (tests and debugging only)."""
        vals = self.vals.detach().cpu().numpy()
        cols = self.cols.cpu().numpy()
        out = np.zeros(vals.shape[:-2] + (self.m, self.n), vals.dtype)
        rows = np.broadcast_to(np.arange(self.m)[:, None], cols.shape)
        np.add.at(out, (..., rows, cols), vals)
        return out

    # -- norms (estimate_norm lower bounds) -------------------------------
    def row_sqnorms(self) -> Tensor:
        return torch.sum(self.vals * self.vals, dim=-1)

    def col_sqnorms(self) -> Tensor:
        sq = self.with_vals(self.vals * self.vals)._t_vals()
        return torch.sum(sq, dim=-1)


# the intermediate size (batch x rows x slots) from which a product over
# shared values takes embedding_bag (chip_smoke.py [ell_products] times
# both forms on the card)
BAG_MIN_ELEMENTS = 1 << 25


def _product(idx: Tensor, w: Tensor, v: Tensor) -> Tensor:
    """out[..., i] = sum_t w[..., i, t] * v[..., idx[i, t]]."""
    if w.ndim == 2 and (v.numel() // v.shape[-1]) * idx.numel() \
            >= BAG_MIN_ELEMENTS:
        return _bag_product(idx, w, v)
    return _gather_product(idx, w, v)


def _gather_product(idx: Tensor, w: Tensor, v: Tensor) -> Tensor:
    """_product as a gather, a multiply and a sum."""
    return torch.sum(w * v[..., idx], dim=-1)


def _bag_product(idx: Tensor, w: Tensor, v: Tensor) -> Tensor:
    """out[..., i] = sum_t w[i, t] * v[..., idx[i, t]] for shared (r, t)
    indices and weights: one embedding_bag over v' (each bag adds its
    weighted rows in slot order, deterministic on every device)."""
    lead = v.shape[:-1]
    table = v.reshape(-1, v.shape[-1]).T.contiguous()      # (width, B)
    out = torch.nn.functional.embedding_bag(
        idx, table, mode="sum", per_sample_weights=w)       # (r, B)
    return out.T.contiguous().reshape(lead + (idx.shape[0],))


def _slot_map(csr) -> tuple[np.ndarray, np.ndarray, int]:
    """Nonzero -> (row, position within the row) of a sorted CSR matrix,
    shared by every ELL constructor."""
    m = csr.shape[0]
    nnz_per_row = np.diff(csr.indptr)
    k = max(1, int(nnz_per_row.max()) if m else 1)
    slot_row = np.repeat(np.arange(m), nnz_per_row)
    slot_pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
    return slot_row, slot_pos, k


def from_scipy(A) -> tuple[np.ndarray, np.ndarray]:
    """(vals, cols) ELL arrays, f64 and int64, from a scipy.sparse
    matrix."""
    import scipy.sparse as sps
    csr = sps.csr_matrix(A)
    csr.sort_indices()
    m, _ = csr.shape
    slot_row, slot_pos, k = _slot_map(csr)
    vals = np.zeros((m, k))
    cols = np.zeros((m, k), np.int64)
    vals[slot_row, slot_pos] = csr.data
    cols[slot_row, slot_pos] = csr.indices
    return vals, cols


def _ell(vals: np.ndarray, cols: np.ndarray, n: int) -> EllMatrix:
    """A CPU EllMatrix with f32 values (the JAX package's cast)."""
    return EllMatrix(vals=torch.as_tensor(vals).to(torch.float32),
                     cols=torch.as_tensor(cols), n=int(n))


def ell_from_scipy(A) -> EllMatrix:
    """EllMatrix from one scipy.sparse matrix."""
    vals, cols = from_scipy(A)
    return _ell(vals, cols, A.shape[1])


def ell_from_scipy_batch(mats) -> EllMatrix:
    """Batched EllMatrix from scipy matrices: vals get a leading scenario
    axis, cols are shared.  Differing sparsity patterns are padded onto
    their union (absent entries hold 0); value-equal matrices collapse
    to one shared (m, k) block."""
    import scipy.sparse as sps
    csrs = []
    for M in mats:
        csr = sps.csr_matrix(M)
        csr.sort_indices()
        csrs.append(csr)
    first = csrs[0]
    m, n = first.shape
    for s, c in enumerate(csrs[1:], start=1):
        if c.shape != (m, n):
            raise ValueError(
                f"scenario {s}: matrix shape {c.shape} differs from "
                f"scenario 0's {(m, n)} (a batch shares one row/column "
                "layout; pad on the host first)")
    shared_pattern = all(
        np.array_equal(c.indptr, first.indptr)
        and np.array_equal(c.indices, first.indices) for c in csrs[1:])
    if not shared_pattern:
        pat = sps.csr_matrix(
            (np.ones_like(first.data), first.indices, first.indptr),
            shape=(m, n))
        for c in csrs[1:]:
            pat = pat + sps.csr_matrix(
                (np.ones_like(c.data), c.indices, c.indptr), shape=(m, n))
        pat = sps.csr_matrix(pat)
        pat.sort_indices()
        pat.data[:] = 1.0
        urows = np.repeat(np.arange(m), np.diff(pat.indptr))
        ucols = pat.indices
        data = np.empty((len(csrs), pat.nnz))
        for s, c in enumerate(csrs):
            data[s] = np.asarray(c[urows, ucols]).reshape(-1)
        slot_row, slot_pos, k = _slot_map(pat)
        cols = np.zeros((m, k), np.int64)
        cols[slot_row, slot_pos] = pat.indices
    else:
        slot_row, slot_pos, k = _slot_map(first)
        cols = np.zeros((m, k), np.int64)
        cols[slot_row, slot_pos] = first.indices
        data = np.empty((len(csrs), first.nnz))
        for s, csr in enumerate(csrs):
            data[s] = csr.data

    if (data[1:] == data[0]).all():
        vals = np.zeros((m, k))
        vals[slot_row, slot_pos] = data[0]
    else:
        vals = np.zeros((len(mats), m, k))
        vals[:, slot_row, slot_pos] = data
    return _ell(vals, cols, n)


def ruiz_scale_ell(vals: np.ndarray, cols: np.ndarray, n: int,
                   iters: int = 10, cones=None):
    """Ruiz equilibration in ELL form, numpy f64 (the sparse analog of
    ops.boxqp.ruiz_scale's loop).  Returns (scaled_vals, d_row, d_col);
    batched vals get per-batch scalings.  `cones` forces block-uniform
    row scales on SOC blocks, as the dense path does."""
    from mpisppy_tpu_torch.ops.boxqp import group_row_scales
    vals = np.asarray(vals, np.float64).copy()
    bshape = vals.shape[:-2]
    m = vals.shape[-2]
    dr = np.ones(bshape + (m,))
    dc = np.ones(bshape + (n,))
    flat_cols = np.asarray(cols).reshape(-1)
    for _ in range(iters):
        rmax = np.max(np.abs(vals), axis=-1)
        # empty rows/columns keep scale 1 (ELL problems legitimately
        # have columns absent from A; a tiny floor would compound)
        rmax = np.where(rmax <= 1e-12, 1.0, rmax)
        rmax = group_row_scales(rmax, cones)
        vals /= np.sqrt(rmax)[..., None]
        dr /= np.sqrt(rmax)
        # one flattened scatter-max for the whole batch: index b * n + col
        B = int(np.prod(bshape)) if bshape else 1
        av = np.abs(vals).reshape(B, -1)
        offs = (np.arange(B)[:, None] * n + flat_cols[None, :]).reshape(-1)
        cflat = np.zeros(B * n)
        np.maximum.at(cflat, offs, av.reshape(-1))
        cmax = cflat.reshape(bshape + (n,))
        cmax = np.where(cmax <= 1e-12, 1.0, cmax)
        sq = np.sqrt(cmax)
        vals /= sq[..., flat_cols].reshape(vals.shape)
        dc /= sq
    return vals, dr, dc
