###############################################################################
# Live session migration (port of mpisppy_tpu/fleet/migration.py;
# docs/serving.md fleet section).
#
# The single-node preemption path (emergency checkpoint at the next
# hub sync -> requeue FRONT with restore=True -> load_checkpoint)
# generalized to a routed operation between replicas sharing one
# checkpoint spool:
#
#   source replica                router                 destination
#   ──────────────                ──────                 ───────────
#   preempt_event set ─┐
#   hub raises at sync │
#   emergency ckpt ────┤
#   worker hands off ──┼─> hand_off(): release quota,
#                      │   detach source trace, emit
#                      │   session-migrated, requeue
#                      │   FRONT with restore=True ────> pop_placed()
#                      │                                 submit_session
#                      │                                 load_checkpoint
#                      │                                 (CRC-validated,
#                      │                                 rotation
#                      │                                 fallback)
#
# Exactly-one-terminal is carried by the Session.settle latch — the
# SAME Session object travels, so even a partitioned source replica
# racing its migrated copy cannot deliver a second outcome.  A session
# that cannot complete the move (no live replica, a worker wedged past
# the drain grace) settles `failed` typed and counts into
# fleet_migrations_lost_total — the counter the regression gate pins
# to zero.
###############################################################################
from __future__ import annotations

import threading

from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.telemetry import metrics as _metrics


class Migrator:
    """The router's migration bookkeeping: the hand-off entry points
    (running and queued flavors) and the dead-replica rescue sweep."""

    def __init__(self, router):
        self.router = router
        # Lock discipline: counters
        # are bumped from replica worker threads and drain threads.
        self._lock = threading.Lock()
        self.started = 0              # guarded-by: _lock
        self.completed = 0            # guarded-by: _lock (hand-offs
                                      # that re-entered the queue)
        self.lost = 0                 # guarded-by: _lock

    def counters(self) -> dict:
        with self._lock:
            return {"started": self.started,
                    "completed": self.completed, "lost": self.lost}

    # -- the running-session hand-off (worker thread of the source) -------
    def hand_off(self, session, payload: dict, replica) -> bool:
        """Take a draining replica's preempted session: the emergency
        checkpoint is on disk (shared spool), the worker already moved
        the session to DEGRADED with restore=True.  Returns True —
        ownership passes to the router."""
        router = self.router
        with self._lock:
            self.started += 1
        session.preempt_event.clear()
        session.migrations += 1
        # the hand-off opens a dedicated MIGRATION child span under the
        # request root : the source segment already detached
        # (server._handle_preemption), the destination's begin_segment
        # opens a sibling — so the wall from this span's start to the
        # next segment's start IS the migration gap spans.py puts on
        # the critical path.  The rows land in the SOURCE trace file
        # (the sink is still attached), the router stream, and the
        # client.
        mig = session.trace.child()
        for bus in (session.bus, router.bus):
            bus.emit(tel.SPAN_START, run=session.run_id, cyl="fleet",
                     trace=mig, name="migration", session=session.sid,
                     from_replica=replica.id)
            bus.emit(tel.SESSION_MIGRATED, run=session.run_id,
                     cyl="fleet", session=session.sid, trace=mig,
                     tenant=session.tenant,
                     from_replica=replica.id,
                     iter=payload.get("iter"),
                     migrations=session.migrations)
        session.detach_trace()
        _metrics.REGISTRY.inc("fleet_sessions_migrated_total")
        router._unassign(session)
        if router.stopping:
            self.mark_lost(session, reason="draining",
                           detail="preempted while the fleet drained; "
                                  "checkpoint retained")
            return True
        router.admission.requeue_front(session)
        with self._lock:
            self.completed += 1
        router.kick()
        return True

    # -- the queued-session hand-off (drain thread of the source) ---------
    def requeue_queued(self, session, replica) -> None:
        """A session that was still QUEUED on the draining replica:
        no checkpoint involved, it simply re-enters the global queue
        (front — it already waited once)."""
        router = self.router
        router.bus.emit(tel.SESSION_MIGRATED, run=session.run_id,
                        cyl="fleet", session=session.sid,
                        trace=session.trace,
                        tenant=session.tenant, from_replica=replica.id,
                        queued=True, migrations=session.migrations)
        router._unassign(session)
        if router.stopping:
            self.mark_lost(session, reason="draining",
                           detail="queued on a drained replica while "
                                  "the fleet stopped")
            return
        router.admission.requeue_front(session)
        router.kick()

    # -- failure accounting ------------------------------------------------
    def mark_lost(self, session, reason: str, detail: str = "") -> None:
        """A migration that could not complete: typed terminal failure
        + the any-increase-gated loss counter (only when THIS call
        delivered the outcome — a session the deadline reaper already
        settled is its failure, not a migration loss)."""
        if session.settle("failed", reason=reason, detail=detail):
            _metrics.REGISTRY.inc("serve_failures_total")
            _metrics.REGISTRY.inc("fleet_migrations_lost_total")
            with self._lock:
                self.lost += 1

    # -- the dead-replica rescue sweep (drain thread) ----------------------
    def rescue(self, replica, grace_s: float) -> None:
        """After a replica's drain grace: any session still assigned
        there and non-terminal failed to hand itself off (a wedged
        worker on a dead box) — it settles typed NOW rather than
        hanging a client forever."""
        import time
        router = self.router
        deadline = time.perf_counter() + float(grace_s)
        while time.perf_counter() < deadline:
            if not router.assigned_to(replica.id):
                return
            time.sleep(0.02)
        for session in router.assigned_to(replica.id):
            if not session.is_terminal():
                self.mark_lost(
                    session, reason="replica-dead",
                    detail=f"replica {replica.id} died and the "
                           f"session did not hand off within "
                           f"{grace_s}s")
            router._unassign(session)
