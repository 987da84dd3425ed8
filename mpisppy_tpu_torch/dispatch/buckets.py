###############################################################################
# Shape buckets: the geometric ladder + batch-axis padding (port of
# mpisppy_tpu/dispatch/buckets.py).
#
# The ladder quantizes the BATCH axis of every dispatch to a small
# geometric set of rungs; (n, m) stay exact.  The fused wheel's
# straggler-tail gather (algos/fused_wheel.py _tail_rescue) quantizes its
# sub-batch size down the same ladder, so every scenario count lands on
# the sizes the JAX package picks.
#
# Padding contract — the invariant everything downstream leans on: pad
# lanes are copies of lane 0, and every per-lane computation in the
# bnb/pdhg stack is independent and deterministic, so a pad lane
# reproduces lane 0's trajectory and host-side control flow over the
# whole batch (all(done), fixed-count stalls, cycle detection) sees the
# same truth values padded or not.  Every reported bound keeps its
# certificate either way.  On the card the window kernel's scenario tile
# follows S (ops/pdhg_window.plan_window), so a lane of a padded batch
# may run in another tile (or, in the split design, over another number
# of blocks, summing in another order) than unpadded; chip_smoke.py's
# [dispatch] phase measures whether lanes stay bit-equal.  BnBOptions.jitter > 0
# draws shape-keyed randoms (padded solves then take different, equally
# valid, tie-breaks).
###############################################################################
from __future__ import annotations

import dataclasses

import torch


class BucketLadder:
    """Geometric batch-size rungs: 1, ceil(g), ceil(g^2), ... (strictly
    increasing; growth g < 2 still steps by at least 1)."""

    def __init__(self, growth: float = 2.0, min_bucket: int = 1):
        if growth <= 1.0:
            raise ValueError(f"bucket growth must exceed 1 ({growth})")
        self.growth = float(growth)
        self.min_bucket = max(1, int(min_bucket))

    def _next(self, r: int) -> int:
        return max(r + 1, int(-(-r * self.growth // 1)))

    def rungs(self, up_to: int):
        """All rungs <= max(up_to, first rung), ascending."""
        out = [self.min_bucket]
        while out[-1] < up_to:
            out.append(self._next(out[-1]))
        return out

    def bucket(self, size: int) -> int:
        """Smallest rung >= size (the padding target)."""
        if size <= 0:
            raise ValueError(f"bucket size must be positive ({size})")
        r = self.min_bucket
        while r < size:
            r = self._next(r)
        return r

    def bucket_floor(self, size: int) -> int:
        """Largest rung <= size (for sub-batch gathers that must not
        exceed the source batch)."""
        if size <= 0:
            raise ValueError(f"bucket size must be positive ({size})")
        r = prev = self.min_bucket
        while r <= size:
            prev = r
            r = self._next(r)
        return prev


_DEFAULT_LADDER = BucketLadder()


def default_ladder() -> BucketLadder:
    return _DEFAULT_LADDER


def _pad_leading(x, batched_ndim: int, pad: int):
    """Append `pad` copies of row 0 along the leading axis of a field
    whose batched rank is `batched_ndim`; shared (lower-rank) fields
    pass through untouched."""
    if getattr(x, "ndim", 0) != batched_ndim:
        return x
    rep = x[:1].expand((pad,) + tuple(x.shape[1:]))
    return torch.cat([x, rep], dim=0)


def pad_qp_batch(qp, d_col, S_to: int):
    """Pad a batched BoxQP (and its column scaling) to S_to lanes with
    copies of lane 0 (the padding contract above).  Returns (qp_padded,
    d_col_padded); a no-op when already at S_to."""
    S = qp.c.shape[0]
    if S_to < S:
        raise ValueError(f"cannot pad {S} lanes down to {S_to}")
    if S_to == S:
        return qp, d_col
    pad = S_to - S
    A = qp.A
    if hasattr(A, "vals"):  # EllMatrix: only a batched vals pads
        if A.vals.ndim == 3:
            A = A.with_vals(_pad_leading(A.vals, 3, pad))
    else:
        A = _pad_leading(A, 3, pad)
    qp2 = dataclasses.replace(
        qp,
        c=_pad_leading(qp.c, 2, pad), q=_pad_leading(qp.q, 2, pad),
        A=A,
        bl=_pad_leading(qp.bl, 2, pad), bu=_pad_leading(qp.bu, 2, pad),
        l=_pad_leading(qp.l, 2, pad), u=_pad_leading(qp.u, 2, pad))
    return qp2, _pad_leading(d_col, 2, pad)


def pad_leading_rows(v, S: int, S_to: int):
    """Pad an auxiliary per-lane tensor (warm starts etc.) from S to
    S_to lanes with copies of row 0; non-tensors and tensors without an
    S-long leading axis pass through untouched."""
    if getattr(v, "ndim", 0) >= 1 and v.shape[0] == S:
        rep = v[:1].expand((S_to - S,) + tuple(v.shape[1:]))
        return torch.cat([v, rep], dim=0)
    return v


def _map_leading(res, fn):
    """A dataclass result with `fn` applied to each tensor field that
    has a leading axis (scalars and plain values pass through)."""
    return dataclasses.replace(res, **{
        f.name: fn(getattr(res, f.name)) for f in dataclasses.fields(res)
        if getattr(getattr(res, f.name), "ndim", 0) >= 1})


def slice_result(res, S: int):
    """Strip the pad lanes off a result: every field with a leading
    batch axis longer than S is cut back to its first S rows (BnBResult
    fields are all (S_pad, ...))."""
    return _map_leading(res, lambda a: a[:S] if a.shape[0] > S else a)


def balanced_split(sizes) -> int:
    """Bisection point for a failing megabatch's request list
    (scheduler._solve_recover): the request index that best halves the
    LANE count, clamped to keep both halves non-empty."""
    sizes = list(sizes)
    if len(sizes) < 2:
        raise ValueError("need at least two requests to split")
    half = sum(sizes) / 2.0
    acc, best_mid, best_err = 0, 1, float("inf")
    for i, s in enumerate(sizes[:-1]):
        acc += s
        err = abs(acc - half)
        if err < best_err:
            best_err, best_mid = err, i + 1
    return best_mid


def shape_signature(qp, d_col) -> tuple:
    """The registry key of a dispatch's DEVICE-FACING shape: batch
    rung, (n, m), dtype, the A storage kind, and which fields carry a
    batch axis."""
    A = qp.A
    if hasattr(A, "vals"):
        akind = ("ell", A.k, A.vals.ndim)
    else:
        akind = ("dense", A.ndim)
    batched = tuple(getattr(f, "ndim", 0)
                    for f in (qp.c, qp.q, qp.bl, qp.bu, qp.l, qp.u,
                              d_col))
    return (qp.c.shape[0], qp.n, qp.m, str(qp.c.dtype).replace("torch.", ""),
            akind, batched)
