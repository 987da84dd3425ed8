###############################################################################
# The warm-start shift between rolling-horizon windows (port of
# mpisppy_tpu/mpc/shift.py).
#
# Between two steps the decision window advances by `stride`: slot
# (g, t) of the new window is slot (g, t + stride) of the old one, so the
# previous step's converged PH plane (duals W (S, N), node averages x̄
# (nodes, N), incumbent nonants x (S, N)) is ROLLED forward along the
# nonant axis, and the tail entries with no rolled source are SPLICED
# fresh.  Everything is one gather:
#
#     new[..., i] = old[..., src_idx[i]]          (then W *= 1 - fresh)
#
# The splice policy per plane:
#   W      zeroed on fresh tail slots: a dual carries step-k pricing that
#          does not exist yet for a slot entering the window, and a zero
#          column keeps the p-weighted node-mean-zero PH invariant (every
#          ROLLED column keeps it: the same gather applies to all
#          scenarios of a column).
#   x̄, x   persistence-filled (src_idx points fresh tails at the last
#          in-window source slot): the standard receding-horizon primal
#          initializer.
#
# The JAX package jits the gather; here it is index_select and one
# multiply on the plane's device (a few (S, N) copies per window).
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ShiftPlan:
    """One horizon's nonant-axis shift, as data.

    src_idx:    (N,) int32 — new slot i reads old slot src_idx[i].
    fresh_mask: (N,) float32 — 1.0 where slot i entered the window this
                step (no rolled source; W is zeroed there), else 0.0.
    """

    src_idx: np.ndarray
    fresh_mask: np.ndarray

    def __post_init__(self):
        src = np.asarray(self.src_idx, np.int32)
        fresh = np.asarray(self.fresh_mask, np.float32)
        if src.shape != fresh.shape or src.ndim != 1:
            raise ValueError(
                f"src_idx {src.shape} and fresh_mask {fresh.shape} must "
                f"be the same (N,) vector")
        if src.size and (src.min() < 0 or src.max() >= src.size):
            raise ValueError("src_idx entries must index the same window")
        object.__setattr__(self, "src_idx", src)
        object.__setattr__(self, "fresh_mask", fresh)

    @property
    def num_nonants(self) -> int:
        return int(self.src_idx.size)


def uc_plan(n_gens: int, n_hours: int, stride: int = 1) -> ShiftPlan:
    """uc nonants are u_{g,t} in g-major layout (slot = g*T + t): hour t
    of the new window was hour t + stride of the old one; the last
    `stride` hours of each generator are fresh (persistence-filled from
    the generator's final in-window hour)."""
    G, T = int(n_gens), int(n_hours)
    stride = int(stride)
    if not (0 < stride <= T):
        raise ValueError(f"stride {stride} outside (0, {T}]")
    t = np.arange(T)
    rolled = t + stride
    src_t = np.where(rolled < T, rolled, T - 1)
    src = (np.arange(G)[:, None] * T + src_t[None, :]).ravel()
    fresh = np.tile((rolled >= T).astype(np.float32), G)
    return ShiftPlan(src_idx=src.astype(np.int32), fresh_mask=fresh)


def ccopf_plan(n_gens: int) -> ShiftPlan:
    """ccopf nonants are generator setpoints at stages 1 and 2
    (stage-major, N = 2*ng): advancing one decision epoch makes the old
    stage-2 plan the new stage-1 plan, and the new stage-2 slots are
    fresh (persistence-filled from old stage 2)."""
    ng = int(n_gens)
    src = np.concatenate([np.arange(ng, 2 * ng),
                          np.arange(ng, 2 * ng)]).astype(np.int32)
    fresh = np.concatenate([np.zeros(ng), np.ones(ng)]).astype(np.float32)
    return ShiftPlan(src_idx=src, fresh_mask=fresh)


def shift_state(W, xbar_nodes, x_non, src_idx, fresh_mask):
    """The shift: (W, x̄_nodes, x) tensors rolled by src_idx along the
    last axis, W zeroed on the fresh tail; on W's device."""
    dev = W.device
    idx = torch.as_tensor(src_idx, dtype=torch.int64, device=dev)
    keep = (1.0 - torch.as_tensor(fresh_mask, device=dev)).to(W.dtype)
    return (torch.index_select(W, -1, idx) * keep,
            torch.index_select(xbar_nodes, -1, idx),
            torch.index_select(x_non, -1, idx))


def shift_warm_plane(plane: dict, plan: ShiftPlan) -> dict:
    """The end-of-step warm plane (numpy dict with W, xbar_nodes, x)
    shifted into the next step's seed, as numpy arrays of W's dtype.
    Deterministic, so a stream that re-shifts a saved plane reproduces
    the uninterrupted stream exactly."""
    W = np.asarray(plane["W"])
    dt = W.dtype

    def t(v):
        return torch.as_tensor(np.asarray(v, dt))
    w, xb, x = shift_state(t(W), t(plane["xbar_nodes"]), t(plane["x"]),
                           plan.src_idx, plan.fresh_mask)
    return {"W": w.numpy(), "xbar_nodes": xb.numpy(), "x": x.numpy()}
