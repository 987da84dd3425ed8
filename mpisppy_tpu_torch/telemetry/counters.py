###############################################################################
# Kernel counters (port of mpisppy_tpu/telemetry/counters.py).
#
# Restart boundaries are where the solver already touches every lane's
# bookkeeping, so ops/pdhg._window folds one window's observations into a
# handful of per-lane int32 counters and one small KKT-score ring there:
# a few elementwise launches per restart window, no host read and no
# change to any CUDA kernel.  The counters ride inside PDHGState
# (`counters`) and are harvested in one device-to-host copy per solver
# whenever the host wants totals — the hub does it once per sync, one
# sync behind (begin_harvest / complete_harvest), leaving the ring on the
# card.
#
# Overhead contract (tests/test_torch_kernel_counters.py): with
# PDHGOptions.telemetry=False the counters field is None and a window
# issues exactly the launches it issues without this module.
#
# The leaves keep the JAX package's order and dtypes (iters, restarts,
# omega_adapt: int32; ring: the solver's dtype; ring_pos: int32), so a
# checkpoint carries them interchangeably (utils/wxbarutils.py).
# ring_pos is a host int here, as PDHGState.k is: the ring's write slot
# is then known on the host and no window waits on the card for it.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch.utils.host_copy import HostCopy

Tensor = torch.Tensor

#: score-sample ring slots per lane (one sample per restart window)
RING_SIZE = 8


@dataclasses.dataclass(frozen=True)
class KernelCounters:
    """Per-lane cumulative counters + a residual-curve sample ring.  All
    counters survive warm restarts across PH iterations (solve()'s
    bookkeeping reset leaves them alone), so totals are per run."""

    iters: Tensor        # (...,) int32 PDHG iterations run while active
    restarts: Tensor     # (...,) int32 adaptive restarts fired
    omega_adapt: Tensor  # (...,) int32 primal-weight adaptations applied
    ring: Tensor         # (..., RING) last KKT scores at window boundaries
    ring_pos: int        # total windows observed (write cursor; host int)


def init_counters(batch_shape: tuple, dtype, device=None,
                  ring_size: int = RING_SIZE) -> KernelCounters:
    def zeros():
        return torch.zeros(batch_shape, dtype=torch.int32, device=device)
    return KernelCounters(
        iters=zeros(), restarts=zeros(), omega_adapt=zeros(),
        ring=torch.full(tuple(batch_shape) + (ring_size,), float("nan"),
                        dtype=dtype, device=device),
        ring_pos=0)


def record_window(kc: KernelCounters, *, active: Tensor, restarted: Tensor,
                  omega_moved: Tensor, score: Tensor,
                  period: int) -> KernelCounters:
    """Fold one restart window's observations into the counters (called
    from ops.pdhg._window only when telemetry is on).  Every field is a
    new tensor: nothing a checkpoint or a harvest still reads is written
    in place."""
    slot = kc.ring_pos % kc.ring.shape[-1]
    ring = torch.cat([kc.ring[..., :slot],
                      score[..., None].to(kc.ring.dtype),
                      kc.ring[..., slot + 1:]], dim=-1)
    act = active.to(torch.int32)
    return KernelCounters(
        iters=kc.iters + act * period,
        restarts=kc.restarts + (restarted & active).to(torch.int32),
        omega_adapt=kc.omega_adapt + (omega_moved & active).to(torch.int32),
        ring=ring,
        ring_pos=kc.ring_pos + 1,
    )


# -- host-side harvest -------------------------------------------------------
def begin_harvest(solver_state, include_ring: bool = True):
    """Non-blocking half of a counter harvest: start the device-to-host
    copies without waiting for them (utils/host_copy.py).  Returns a
    handle for complete_harvest, or None when the state carries no
    counters (telemetry off).  include_ring=False copies only the newest
    ring slot (the per-sync hot path: the median gauge needs one
    sample)."""
    kc = getattr(solver_state, "counters", None)
    if kc is None:
        return None
    ring_size = kc.ring.shape[-1]
    parts = [kc.iters, kc.restarts, kc.omega_adapt,
             solver_state.guard_resets]
    if include_ring:
        parts.append(kc.ring)
    else:
        # before any window has written, the slot holds the NaN ring
        # fill and drops out of the median in complete_harvest
        parts.append(kc.ring[..., (kc.ring_pos - 1) % ring_size])
    return HostCopy(parts), kc.ring_pos, include_ring, ring_size


def complete_harvest(handle) -> dict | None:
    """Blocking half: a begin_harvest handle into the totals dict.
    Cheap when the copies already landed."""
    if handle is None:
        return None
    copy, pos, include_ring, ring_size = handle
    vals = copy.values()
    iters, restarts, omega, guard = vals[:4]
    ring = None
    if include_ring:
        ring = np.array(vals[4])
        last = ring[..., (pos - 1) % ring_size] if pos > 0 \
            else np.full(ring.shape[:-1], np.nan)
    else:
        last = np.asarray(vals[4])
    finite = np.asarray(last)[np.isfinite(np.asarray(last))]
    out = {
        "pdhg_iterations_total": int(np.sum(iters)),
        "pdhg_restarts_total": int(np.sum(restarts)),
        "pdhg_omega_adaptations_total": int(np.sum(omega)),
        "pdhg_guard_resets_total": int(np.sum(guard)),
        "pdhg_windows_total": pos,
        "pdhg_last_score_median": float(np.median(finite))
        if finite.size else float("nan"),
    }
    if include_ring:
        out["residual_ring"] = ring
    return out


def harvest_state(solver_state, include_ring: bool = True) -> dict | None:
    """Synchronous harvest of a PDHGState's counters (plus the lane-guard
    totals already in the state): begin_harvest completed at once.  None
    when the state carries no counters."""
    return complete_harvest(begin_harvest(solver_state, include_ring))


def per_lane(solver_state) -> dict | None:
    """The per-lane counters of a PDHGState as numpy arrays (iters,
    restarts, omega_adapt), or None with telemetry off — what the
    kernel-counters event sums."""
    kc = getattr(solver_state, "counters", None)
    if kc is None:
        return None
    return {name: getattr(kc, name).cpu().numpy()
            for name in ("iters", "restarts", "omega_adapt")}


def fold_into_registry(registry, harvested: dict, cyl: str = "hub"):
    """Mirror harvested ABSOLUTE totals into a MetricsRegistry (set, not
    inc: the device counters are cumulative and the source of truth)."""
    for name in ("pdhg_iterations_total", "pdhg_restarts_total",
                 "pdhg_omega_adaptations_total",
                 "pdhg_guard_resets_total", "pdhg_windows_total"):
        registry.set_counter(name, harvested[name], cyl=cyl)
    med = harvested["pdhg_last_score_median"]
    if med == med:  # not NaN
        registry.set_gauge("pdhg_last_score_median", med, cyl=cyl)
