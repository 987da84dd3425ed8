###############################################################################
# Second-order-cone rows for the BoxQP kernel (port of
# mpisppy_tpu/ops/cones.py).
#
# Contract (docs/cones.md):
#
#   * A ConeSpec PARTITIONS the m constraint rows of a BoxQP into box
#     rows and disjoint SOC blocks.  A block is a set of rows
#     (head; tail_1..tail_d) whose constraint is
#
#         (A x - b)_block  in  K_soc,  i.e.
#         a_head'x - b_head  >=  || (A x - b)_tail ||_2
#
#     with the per-row shifts b stored in BOTH bl and bu of the block's
#     rows (bl == bu == b).  dual_objective's box accounting then
#     collapses to b'y on SOC rows, and Ruiz row scaling scales the
#     shift with its block (row scales are uniform within a block; see
#     boxqp.group_row_scales).
#   * Blocks are ragged; `seg` maps every row to its block id, box rows
#     to the sentinel segment `num_cones`, so each blockwise reduction
#     is one index_add over the row axis, batched over scenarios.
#   * The dual prox of the row indicator, division-free:
#         box rows:  y1 = w - clip(w, sigma*bl, sigma*bu)
#         SOC rows:  y1 = Proj_polar(w - sigma*b)
#     so dual iterates lie in the polar cone -K (SOC is self-dual).
#
# The CUDA window kernel (csrc/pdhg_window.cu) reads the blocks as a
# CSR view, ConeSpec.csr(): cone_ptr (C+1,) and cone_rows, head first.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

_TINY = 1e-30


@dataclasses.dataclass(frozen=True, eq=False)
class ConeSpec:
    """Static partition of a BoxQP's m rows into box rows + SOC blocks.

    is_soc:    (m,) bool — row belongs to some SOC block.
    is_head:   (m,) bool — row is its block's head (the t component).
    seg:       (m,) int64 — block id for SOC rows; `num_cones` (the
               sentinel segment) for box rows.
    num_cones: block count.
    max_dim:   max block dimension (head + tails).
    head_rows: (num_cones,) tuple — block b's head row index."""

    is_soc: Tensor
    is_head: Tensor
    seg: Tensor
    num_cones: int
    max_dim: int
    head_rows: tuple = ()
    # device -> (cone_ptr, cone_rows) int32 tensors, filled by csr()
    _csr: dict = dataclasses.field(default_factory=dict, init=False,
                                   repr=False)

    @property
    def m(self) -> int:
        return self.is_soc.shape[0]

    @property
    def device(self) -> torch.device:
        return self.seg.device

    def to(self, device) -> "ConeSpec":
        """The same spec with its tensors on `device`."""
        return ConeSpec(is_soc=self.is_soc.to(device),
                        is_head=self.is_head.to(device),
                        seg=self.seg.to(device), num_cones=self.num_cones,
                        max_dim=self.max_dim, head_rows=self.head_rows)

    def csr(self, device=None) -> tuple[Tensor, Tensor]:
        """(cone_ptr (C+1,), cone_rows (nnz,)) int32 on `device`: block
        b's rows are cone_rows[cone_ptr[b]:cone_ptr[b+1]], head first,
        tails in row order.  Built once per device and cached."""
        dev = torch.device(self.device if device is None else device)
        key = str(dev)
        if key not in self._csr:
            seg = self.seg.cpu().numpy()
            head = self.is_head.cpu().numpy()
            rows = np.nonzero(self.is_soc.cpu().numpy())[0]
            # primary key block id, then head first, then row index
            rows = rows[np.lexsort((rows, ~head[rows], seg[rows]))]
            counts = np.bincount(seg[rows], minlength=self.num_cones)
            ptr = np.concatenate([[0], np.cumsum(counts)])
            self._csr[key] = (
                torch.as_tensor(ptr.astype(np.int32), device=dev),
                torch.as_tensor(rows.astype(np.int32), device=dev))
        return self._csr[key]


def cone_spec(m: int, blocks, device=None) -> ConeSpec:
    """Build a ConeSpec from `blocks`: a list of int row-index arrays,
    HEAD FIRST, each of length >= 2, pairwise disjoint.  The tensors
    land on `device` (default: the CPU)."""
    is_soc = np.zeros(m, bool)
    is_head = np.zeros(m, bool)
    seg = np.full(m, len(blocks), np.int64)
    max_dim = 0
    heads = []
    for b, rows in enumerate(blocks):
        rows = np.asarray(rows, np.int64)
        if rows.ndim != 1 or len(rows) < 2:
            raise ValueError(f"SOC block {b}: need head + >=1 tail rows")
        if len(np.unique(rows)) != len(rows):
            # duplicates would collapse in the assignments below and
            # silently build a looser cone than specified
            raise ValueError(f"SOC block {b}: duplicate row indices")
        if is_soc[rows].any():
            raise ValueError(f"SOC block {b}: overlaps another block")
        is_soc[rows] = True
        is_head[rows[0]] = True
        heads.append(int(rows[0]))
        seg[rows] = b
        max_dim = max(max_dim, len(rows))
    dev = torch.device("cpu" if device is None else device)
    return ConeSpec(
        is_soc=torch.as_tensor(is_soc, device=dev),
        is_head=torch.as_tensor(is_head, device=dev),
        seg=torch.as_tensor(seg, device=dev), num_cones=len(blocks),
        max_dim=max_dim, head_rows=tuple(heads))


def _blockwise(spec: ConeSpec, v: Tensor):
    """(t, znorm) per segment: head values and tail 2-norms, (..., C+1)."""
    C = spec.num_cones + 1
    zero = torch.zeros_like(v)
    tail = torch.where(spec.is_soc & ~spec.is_head, v, zero)
    head = torch.where(spec.is_head, v, zero)
    base = v.new_zeros(v.shape[:-1] + (C,))
    zsq = base.index_add(-1, spec.seg, tail * tail)
    t = base.index_add(-1, spec.seg, head)
    return t, torch.sqrt(zsq)


def project_soc_rows(spec: ConeSpec, v: Tensor) -> Tensor:
    """Rowwise Euclidean projection of each SOC block of `v` onto the
    second-order cone {(t, z): ||z|| <= t}; box rows pass through.

    Cases (per block): interior/boundary (||z|| <= t) identity; polar
    (||z|| <= -t) zero; else the reflection case
    proj = (alpha, alpha z/||z||), alpha = (t + ||z||)/2."""
    t, znorm = _blockwise(spec, v)
    inside = znorm <= t
    polar = znorm <= -t
    alpha = 0.5 * (t + znorm)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    scale = torch.where(inside, one,
                        torch.where(polar, zero,
                                    alpha / torch.clamp(znorm, min=_TINY)))
    t_new = torch.where(inside, t, torch.where(polar, zero, alpha))
    proj = torch.where(spec.is_head, t_new[..., spec.seg],
                       v * scale[..., spec.seg])
    return torch.where(spec.is_soc, proj, v)


def project_polar_rows(spec: ConeSpec, v: Tensor) -> Tensor:
    """Rowwise projection of SOC blocks onto the POLAR cone -K (Moreau:
    Proj_{-K}(v) = v - Proj_K(v)); box rows pass through."""
    return torch.where(spec.is_soc, v - project_soc_rows(spec, v), v)


def dual_prox(spec: ConeSpec, w: Tensor, sigma: Tensor, bl: Tensor,
              bu: Tensor) -> Tensor:
    """Generalized PDHG dual prox: y1 = w - sigma * Proj_set(w / sigma)
    with the row set [bl, bu] on box rows and b + K on SOC blocks (shift
    b read off bl).  Division-free:
        box:  y1 = w - clip(w, sigma*bl, sigma*bu)
        SOC:  y1 = Proj_polar(w - sigma*b).
    `sigma` broadcasts over the row axis ((..., 1) from callers)."""
    box = w - torch.clamp(w, sigma * bl, sigma * bu)
    shift = torch.where(spec.is_soc, bl, torch.zeros_like(bl))
    wsh = w - sigma * shift
    soc = wsh - project_soc_rows(spec, wsh)
    return torch.where(spec.is_soc, soc, box)


def primal_violation_rows(spec: ConeSpec, ax: Tensor, bl: Tensor) -> Tensor:
    """Rowwise |ax - Proj_{b+K}(ax)| on SOC rows, 0 on box rows — the
    conic analog of the box row residual max(ax-bu,0)+max(bl-ax,0)."""
    shift = torch.where(spec.is_soc, bl, torch.zeros_like(bl))
    v = ax - shift
    viol = (v - project_soc_rows(spec, v)).abs()
    return torch.where(spec.is_soc, viol, torch.zeros_like(viol))


def dual_cone_residual_rows(spec: ConeSpec, y: Tensor) -> Tensor:
    """Rowwise distance |y - Proj_{-K}(y)| of each dual SOC block to the
    polar cone (0 on box rows).  Zero at every PDHG iterate and window
    average; kkt_residuals folds its max into the dual residual, so
    every bound-publication gate inherits the check."""
    res = (y - project_polar_rows(spec, y)).abs()
    return torch.where(spec.is_soc, res, torch.zeros_like(res))


def head_membership(spec: ConeSpec, num_segments: int | None = None):
    """(C, m) f32 head/tail membership matrices (Mhead, Mtail): the
    matrix form of the segment map the Pallas kernel reduces with."""
    C = spec.num_cones if num_segments is None else num_segments
    rows = torch.arange(spec.m, device=spec.device)
    seg = torch.clamp(spec.seg, 0, C - 1)
    head = torch.zeros((C, spec.m), dtype=torch.float32, device=spec.device)
    tail = torch.zeros_like(head)
    head.index_put_((seg, rows), (spec.is_soc & spec.is_head).float(),
                    accumulate=True)
    tail.index_put_((seg, rows), (spec.is_soc & ~spec.is_head).float(),
                    accumulate=True)
    return head, tail


def validate_against_bounds(spec: ConeSpec, bl, bu, atol: float = 0.0):
    """Host-side check of the ConeSpec contract: every SOC row must carry
    bl == bu (the shift).  Call at build time, not in hot paths."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    bl, bu = host(bl), host(bu)
    soc = host(spec.is_soc)
    bad = soc & ~(np.abs(bl - bu) <= atol)
    bad = bad.reshape(-1, bad.shape[-1])
    if bad.any():
        rows = np.nonzero(bad.any(0))[0]
        raise ValueError(
            f"SOC rows {rows.tolist()} must store their shift in both "
            "bl and bu (bl == bu); got differing bounds")
