###############################################################################
# Batched feasibility-based bound tightening, the presolve (port of
# mpisppy_tpu/ops/fbbt.py; ref:mpisppy/opt/presolve.py:25,61-260).
#
# A sweep of interval arithmetic over every row of every scenario:
#
#   row activity bounds     Lmin_i = sum_j min(a_ij l_j, a_ij u_j)
#                           Lmax_i = sum_j max(a_ij l_j, a_ij u_j)
#   per-(row, col) implied  a_ij x_j <= bu_i - (Lmin_i - min-term_ij)
#   bounds                  a_ij x_j >= bl_i - (Lmax_i - max-term_ij)
#   column tightening       u_j <- min over rows, l_j <- max over rows
#   integer rounding        l_j <- ceil(l_j), u_j <- floor(u_j)
#
# Infinite activity terms are counted, never summed: a clipped 1e30
# magnitude would absorb the finite terms below its ulp and fabricate
# tightenings.  A dense A works on (..., m, n) products; an EllMatrix on
# its (..., m, k) slots with one gather and a scatter-min/max to the
# columns.  presolve_batch then intersects the nonant bounds across the
# scenarios of each tree node (the reference's MIN/MAX Allreduce).
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch.ops.boxqp import BoxQP
from mpisppy_tpu_torch.ops.sparse import EllMatrix

Tensor = torch.Tensor

_BIG = 1e30  # stand-in for inf inside interval arithmetic (avoids inf-inf)


def _clean(lo: Tensor, hi: Tensor):
    """+-inf to +-_BIG, so activity products never give NaN (0 * inf);
    infinite terms are tracked symbolically by the sweeps."""
    return torch.clamp(lo, -_BIG, _BIG), torch.clamp(hi, -_BIG, _BIG)


def _inf_terms(a: Tensor, raw_l: Tensor, raw_u: Tensor):
    """(min_inf, max_inf): which activity terms are infinite, off the RAW
    bounds (|b| >= _BIG counts as infinite, so 1e30 sentinels behave like
    inf)."""
    pos, neg = a > 0.0, a < 0.0
    lo_inf = ~(raw_l.abs() < _BIG)
    hi_inf = ~(raw_u.abs() < _BIG)
    return (pos & lo_inf) | (neg & hi_inf), (pos & hi_inf) | (neg & lo_inf)


def _rooms(t_min, t_max, min_inf, max_inf, bl, bu):
    """Per-(row, col) slack on each row side.  Infinite min/max terms add
    zero to the finite sums and are counted; column j may be tightened
    only from a side whose infinite-term count, its own term excluded, is
    zero."""
    zero = torch.zeros_like(t_min)
    t_min_f = torch.where(min_inf, zero, t_min)
    t_max_f = torch.where(max_inf, zero, t_max)
    n_min_inf = min_inf.sum(dim=-1, keepdim=True)
    n_max_inf = max_inf.sum(dim=-1, keepdim=True)
    resid_min = t_min_f.sum(dim=-1, keepdim=True) - t_min_f
    resid_max = t_max_f.sum(dim=-1, keepdim=True) - t_max_f
    ok_min = (n_min_inf - min_inf.to(n_min_inf.dtype)) == 0
    ok_max = (n_max_inf - max_inf.to(n_max_inf.dtype)) == 0
    inf = torch.full_like(t_min, float("inf"))
    bl_b = torch.clamp(bl, -_BIG, _BIG)[..., :, None]
    bu_b = torch.clamp(bu, -_BIG, _BIG)[..., :, None]
    up_room = torch.where(torch.isfinite(bu)[..., :, None] & ok_min,
                          bu_b - resid_min, inf)
    lo_room = torch.where(torch.isfinite(bl)[..., :, None] & ok_max,
                          bl_b - resid_max, -inf)
    return up_room, lo_room


def _implied(a: Tensor, up_room: Tensor, lo_room: Tensor):
    """Per-entry implied (upper, lower) bounds of x_j from each row."""
    pos, neg = a > 0.0, a < 0.0
    inf = torch.full_like(a, float("inf"))
    asafe = torch.where(a == 0.0, torch.ones_like(a), a)
    ub = torch.minimum(torch.where(pos, up_room / asafe, inf),
                       torch.where(neg, lo_room / asafe, inf))
    lb = torch.maximum(torch.where(pos, lo_room / asafe, -inf),
                       torch.where(neg, up_room / asafe, -inf))
    return ub, lb


def _sweep_dense(A: Tensor, bl, bu, l, u):  # noqa: E741
    """One FBBT sweep, dense A ((m, n) or (S, m, n); l, u (..., n))."""
    lo, hi = _clean(l, u)
    lo_b, hi_b = lo[..., None, :], hi[..., None, :]
    t_min = torch.minimum(A * lo_b, A * hi_b)       # (..., m, n)
    t_max = torch.maximum(A * lo_b, A * hi_b)
    min_inf, max_inf = _inf_terms(A, l[..., None, :], u[..., None, :])
    up_room, lo_room = _rooms(t_min, t_max, min_inf, max_inf, bl, bu)
    ub, lb = _implied(A, up_room, lo_room)
    return torch.maximum(l, lb.amax(dim=-2)), torch.minimum(u, ub.amin(dim=-2))


def _sweep_ell(ell: EllMatrix, bl, bu, l, u):  # noqa: E741
    """One FBBT sweep on an EllMatrix: gather the column boxes to the
    slots, reduce the rows, scatter-min/max the implied bounds back to
    the columns (padding slots carry +-inf: no-ops)."""
    vals, cols, n = ell.vals, ell.cols, ell.n
    lo, hi = _clean(l, u)
    gl, gu = lo[..., cols], hi[..., cols]
    t_min = torch.minimum(vals * gl, vals * gu)     # (..., m, k)
    t_max = torch.maximum(vals * gl, vals * gu)
    min_inf, max_inf = _inf_terms(vals, l[..., cols], u[..., cols])
    up_room, lo_room = _rooms(t_min, t_max, min_inf, max_inf, bl, bu)
    slot_ub, slot_lb = _implied(vals, up_room, lo_room)
    bshape = slot_ub.shape[:-2]
    flat = cols.reshape(-1).expand(bshape + (cols.numel(),))
    new_u = torch.full(bshape + (n,), float("inf"), dtype=l.dtype,
                       device=l.device).scatter_reduce(
        -1, flat, slot_ub.reshape(bshape + (-1,)), "amin")
    new_l = torch.full(bshape + (n,), -float("inf"), dtype=l.dtype,
                       device=l.device).scatter_reduce(
        -1, flat, slot_lb.reshape(bshape + (-1,)), "amax")
    return torch.maximum(l, new_l), torch.minimum(u, new_u)


def _head_activity_max(qp: BoxQP, l: Tensor, u: Tensor):  # noqa: E741
    """(Lmax_finite, has_inf) of the SOC head rows only, (..., C): the
    finite part of the interval activity upper bound and whether any
    term is (symbolically) infinite, with the sweeps' conventions."""
    hr = torch.as_tensor(np.asarray(qp.cones.head_rows, np.int64),
                         device=l.device)
    lo, hi = _clean(l, u)
    if isinstance(qp.A, EllMatrix):
        vals, cols = qp.A.vals[..., hr, :], qp.A.cols[hr]
        t_max = torch.maximum(vals * lo[..., cols], vals * hi[..., cols])
        _, max_inf = _inf_terms(vals, l[..., cols], u[..., cols])
    else:
        A = qp.A[..., hr, :]
        t_max = torch.maximum(A * lo[..., None, :], A * hi[..., None, :])
        _, max_inf = _inf_terms(A, l[..., None, :], u[..., None, :])
    Lmax_f = torch.where(max_inf, torch.zeros_like(t_max), t_max).sum(-1)
    return Lmax_f, max_inf.any(dim=-1)


def _soc_effective_bounds(qp: BoxQP, l: Tensor, u: Tensor):  # noqa: E741
    """Conservative row intervals for SOC blocks (norm-ball bounds).  The
    block stores its shift b in bl == bu; reading that as an equality
    row would cut the cone to its apex.  Valid implications instead:

      head:  a_h'x - b_h = t >= ||z|| >= 0      ->  row in [b_h, +inf)
      tails: |a_i'x - b_i| = |z_i| <= t <= t_ub ->  row in [b_i -+ t_ub]

    with t_ub the head row's interval activity upper bound minus b_h
    (an infinite head activity leaves the tails untightened).  Box rows
    keep their bounds."""
    spec = qp.cones
    hr = torch.as_tensor(np.asarray(spec.head_rows, np.int64),
                         device=l.device)
    Lmax_h, has_inf_h = _head_activity_max(qp, l, u)   # (..., C)
    room = Lmax_h - qp.bl[..., hr]
    bshape = Lmax_h.shape[:-1]
    pad = torch.zeros(bshape + (1,), dtype=Lmax_h.dtype, device=l.device)
    blk = torch.cat([torch.broadcast_to(room, bshape + room.shape[-1:]),
                     pad], dim=-1)
    blk_inf = torch.cat([torch.broadcast_to(
        has_inf_h.to(Lmax_h.dtype), bshape + (spec.num_cones,)), pad],
        dim=-1)
    inf = torch.full_like(blk[..., spec.seg], float("inf"))
    t_ub = torch.where(blk_inf[..., spec.seg] > 0.0, inf,
                       torch.clamp(blk[..., spec.seg], min=0.0))
    tail = spec.is_soc & ~spec.is_head
    bl_eff = torch.where(tail, qp.bl - t_ub, qp.bl)
    bu_eff = torch.where(spec.is_soc,
                         torch.where(spec.is_head, inf, qp.bu + t_ub), qp.bu)
    return bl_eff, bu_eff


def fbbt(qp: BoxQP, n_sweeps: int = 3, d_col: Tensor | None = None,
         integer: Tensor | None = None):
    """`n_sweeps` of interval tightening over a (possibly batched,
    possibly Ruiz-scaled) BoxQP.  Returns (l, u): scaled-space boxes,
    never looser than the input.  With d_col and integer, integer columns
    are rounded to integral ORIGINAL-space bounds each sweep
    (x_orig = d_col * x)."""
    S_shape = qp.c.shape
    l0 = torch.broadcast_to(qp.l, S_shape)
    u0 = torch.broadcast_to(qp.u, S_shape)
    eps = 1e-6

    def round_int(l, u):  # noqa: E741
        if integer is None or d_col is None:
            return l, u
        d = torch.broadcast_to(d_col, l.shape)
        l_orig = torch.ceil(l * d - eps)
        u_orig = torch.floor(u * d + eps)
        return (torch.where(integer, l_orig / d, l),
                torch.where(integer, u_orig / d, u))

    l, u = round_int(l0, u0)  # noqa: E741
    for _ in range(n_sweeps):
        if qp.cones is None:
            bl, bu = qp.bl, qp.bu
        else:
            # re-relaxed every sweep: the norm-ball widths shrink as the
            # head rows' activity bounds tighten
            bl, bu = _soc_effective_bounds(qp, l, u)
        if isinstance(qp.A, EllMatrix):
            l, u = _sweep_ell(qp.A, bl, bu, l, u)  # noqa: E741
        else:
            l, u = _sweep_dense(qp.A, bl, bu, l, u)  # noqa: E741
        l, u = round_int(l, u)  # noqa: E741
    return l, u


def presolve_batch(batch, n_sweeps: int = 3, feas_tol: float = 1e-6,
                   raise_on_infeasible: bool = True):
    """FBBT sweeps on every scenario of a ScenarioBatch, then the
    cross-scenario nonant-bound intersection per tree node (valid because
    nonanticipative variables are equal across their node's scenarios).

    Returns (new_batch, info): info['tightened_bounds'] counts the bounds
    that moved, info['infeasible'] is the (S,) bool mask of scenarios
    whose box came out empty.  An infeasible scenario raises ValueError
    unless raise_on_infeasible is False: the returned batch clamps empty
    boxes to a point to stay solvable, which must not be mistaken for the
    real problem."""
    qp = batch.qp
    S_all = batch.num_scenarios
    # a dense sweep materializes (S, m, n) intermediates: chunk the
    # scenario axis at ~2e7 elements (the ELL path is (S, m, k))
    if not isinstance(qp.A, EllMatrix) and S_all * qp.m * qp.n > 2e7:
        chunk = max(1, int(2e7 / (qp.m * qp.n)))
        ls, us = [], []
        for s0 in range(0, S_all, chunk):
            sl = slice(s0, min(s0 + chunk, S_all))

            def cut(x, batched_ndim):
                return x[sl] if x.ndim == batched_ndim else x

            qp_c = dataclasses.replace(
                qp, c=cut(qp.c, 2), q=cut(qp.q, 2), A=cut(qp.A, 3),
                bl=cut(qp.bl, 2), bu=cut(qp.bu, 2),
                l=cut(qp.l, 2), u=cut(qp.u, 2))
            lc, uc = fbbt(qp_c, n_sweeps=n_sweeps,
                          d_col=cut(batch.d_col, 2),
                          integer=batch.integer_full)
            ls.append(lc)
            us.append(uc)
        l1, u1 = torch.cat(ls, dim=0), torch.cat(us, dim=0)
    else:
        l1, u1 = fbbt(qp, n_sweeps=n_sweeps, d_col=batch.d_col,
                      integer=batch.integer_full)

    # cross-scenario nonant intersection, in ORIGINAL space, per node
    S, n = l1.shape
    N = batch.num_nonants
    idx = batch.nonant_idx
    d_non = torch.broadcast_to(batch.d_non, (S, N))
    l_non = l1[:, idx] * d_non
    u_non = u1[:, idx] * d_non
    real = (batch.p > 0.0)[:, None]
    nnodes = batch.tree.num_nodes
    key = (batch.node_of_slot * N
           + torch.arange(N, device=idx.device)[None, :]).reshape(-1)
    big = torch.full_like(l_non, _BIG)
    lmax = torch.full((nnodes * N,), -float("inf"), dtype=l1.dtype,
                      device=l1.device).scatter_reduce(
        0, key, torch.where(real, l_non, -big).reshape(-1), "amax")
    umin = torch.full((nnodes * N,), float("inf"), dtype=l1.dtype,
                      device=l1.device).scatter_reduce(
        0, key, torch.where(real, u_non, big).reshape(-1), "amin")
    l_non2 = torch.gather(lmax.reshape(nnodes, N), 0, batch.node_of_slot)
    u_non2 = torch.gather(umin.reshape(nnodes, N), 0, batch.node_of_slot)
    l2, u2 = l1.clone(), u1.clone()
    l2[:, idx] = torch.maximum(l1[:, idx], l_non2 / d_non)
    u2[:, idx] = torch.minimum(u1[:, idx], u_non2 / d_non)

    infeasible = (torch.any(l2 > u2 + feas_tol, dim=1)
                  & (batch.p > 0.0)).cpu().numpy()
    if raise_on_infeasible and infeasible.any():
        raise ValueError(
            f"FBBT proved scenario(s) {np.nonzero(infeasible)[0].tolist()} "
            "infeasible (empty variable box after tightening)")

    l0 = torch.broadcast_to(qp.l, (S, n))
    u0 = torch.broadcast_to(qp.u, (S, n))
    moved = int((l2 > l0 + 1e-9).sum()) + int((u2 < u0 - 1e-9).sum())
    info = {"tightened_bounds": moved, "infeasible": infeasible}
    new_qp = dataclasses.replace(qp, l=l2, u=torch.maximum(l2, u2))
    return dataclasses.replace(batch, qp=new_qp), info
