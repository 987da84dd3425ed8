###############################################################################
# Fleet health plane (port of mpisppy_tpu/fleet/health.py;
# docs/serving.md fleet section).
#
# Replica liveness rides heartbeats into the router: each replica's
# beat thread refreshes its last-beat clock every heartbeat_s, and the
# router's monitor ages those clocks through this board:
#
#   UP ──(beat stale > miss_budget beats)──> SUSPECT
#   SUSPECT ──(status probe over the replica socket answers)──> stays
#             SUSPECT (a slow-heartbeat replica is degraded, not dead)
#   SUSPECT ──(probe fails too)──> DEAD  (fenced: sticky — a replica
#             that reappears after a partition is NOT readmitted, so a
#             split brain can never double-assign; the settle latch
#             is the second line of defense)
#   SUSPECT ──(beats resume)──> UP  (recovered)
#
# Every transition emits one `replica-state` event on the router bus.
###############################################################################
from __future__ import annotations

import threading

from mpisppy_tpu_torch import telemetry as tel

UP = "UP"
SUSPECT = "SUSPECT"
DEAD = "DEAD"


class HealthBoard:
    """The router's view of replica liveness (see module header).
    observe() is called by the monitor loop with the two signals it
    has — beat freshness and, when stale, the socket probe verdict —
    and returns the new state when a transition happened (None
    otherwise).  DEAD is sticky (fencing)."""

    def __init__(self, bus=None, run_id: str = ""):
        self.bus = bus
        self.run_id = run_id
        self._lock = threading.Lock()
        self._state: dict = {}        # guarded-by: _lock

    def state(self, rid: str) -> str:
        with self._lock:
            return self._state.get(rid, UP)

    def _move(self, rid: str, new: str):   # holds-lock: _lock
        old = self._state.get(rid, UP)
        if old == new or old == DEAD:
            return None
        self._state[rid] = new
        return old

    def observe(self, rid: str, fresh: bool,
                probe_ok: bool | None = None,
                reason: str = "") -> str | None:
        """One monitor reading.  fresh = the replica's beat clock is
        within the miss budget; probe_ok = the status-probe verdict
        (only consulted when stale).  Returns the entered state on a
        transition."""
        if fresh:
            new = UP
        elif probe_ok:
            new = SUSPECT
        else:
            new = DEAD
        with self._lock:
            old = self._move(rid, new)
        if old is None:
            return None
        if self.bus is not None:
            self.bus.emit(tel.REPLICA_STATE, run=self.run_id,
                          cyl="fleet", replica=rid, state=new,
                          prev=old, reason=reason)
        return new

    def force(self, rid: str, new: str, reason: str = "") -> str | None:
        """Out-of-band transition (a replica's own kill seam, a drain
        decision) — same stickiness and event emission as observe."""
        with self._lock:
            old = self._move(rid, new)
        if old is None:
            return None
        if self.bus is not None:
            self.bus.emit(tel.REPLICA_STATE, run=self.run_id,
                          cyl="fleet", replica=rid, state=new,
                          prev=old, reason=reason)
        return new

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._state)
