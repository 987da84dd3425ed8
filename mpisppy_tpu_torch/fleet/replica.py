###############################################################################
# One fleet replica (port of mpisppy_tpu/fleet/replica.py;
# docs/serving.md fleet section).
#
# A Replica wraps a full WheelServer — its own socket (the
# status/ping health ops ride it), its own engine with its own
# StructureInterner (one device stream's worth of structure pool), its
# own trace subdirectory (trace_dir/<rid>/) — plus the fleet plumbing:
#
#   * a HEARTBEAT thread refreshing the router-visible beat clock every
#     heartbeat_s, through the ReplicaFault seams (kill stops the loop,
#     partition suppresses the refresh, slow_heartbeat delays it);
#   * a HAND-OFF seam: while the replica drains, a preempted session is
#     handed back to the router (WheelServer._preemption_handoff)
#     instead of the local queue — the live-migration exit door;
#   * DRAIN: queued sessions hand back immediately, running sessions
#     get their preempt_event set so the hub raises at its next sync
#     prologue (emergency checkpoint = the SIGTERM grace window a real
#     preemption grants), and the wrapper waits out the grace period.
#
# The replica's LOCAL FairQueue is deliberately non-binding (quota =
# max_running): global WFQ/quota/SLA policy lives in the router's
# FleetAdmission; locally the queue is just the assignment buffer.
###############################################################################
from __future__ import annotations

import threading
import time

import torch

from mpisppy_tpu_torch.serve import server as srv_mod


def check_device(device: str) -> None:
    """The fleet serves on CUDA unless told "cpu": without a card it
    raises instead of landing on the CPU silently."""
    if str(device) != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"fleet: device {device!r} needs CUDA and "
            "torch.cuda.is_available() is false; pass device='cpu' to "
            "serve on the CPU")


class _ReplicaServer(srv_mod.WheelServer):
    """WheelServer whose preemption path can hand a session back to
    the fleet router (see WheelServer._preemption_handoff)."""

    def __init__(self, options, handoff=None):
        super().__init__(options)
        self._handoff = handoff

    def _preemption_handoff(self, session, payload: dict) -> bool:
        if self._handoff is None:
            return False
        return self._handoff(session, payload)


class Replica:
    """One replica of the serve fleet (see module header)."""

    def __init__(self, rid: str, options: srv_mod.ServeOptions,
                 heartbeat_s: float = 0.2, fault_plan=None,
                 on_down=None, router_handoff=None,
                 max_keys: int = 256):
        check_device(options.device)
        self.id = rid
        self.heartbeat_s = float(heartbeat_s)
        self.fault_plan = fault_plan
        self.max_running = options.max_running
        self._on_down = on_down              # callable(replica, reason)
        self._router_handoff = router_handoff  # callable(session,
                                               # payload, replica)->bool
        self.server = _ReplicaServer(options, handoff=self._maybe_handoff)
        # Lock discipline: the beat
        # clock and liveness flags are shared by the beat thread, the
        # router's monitor/scheduler, and the drain thread.
        self._lock = threading.Lock()
        self._beats = 0                   # guarded-by: _lock
        self.last_beat = time.perf_counter()  # guarded-by: _lock
        self._dead = False                # guarded-by: _lock
        self._draining = False            # guarded-by: _lock
        self._closed = False              # guarded-by: _lock
        self._keys: dict = {}             # guarded-by: _lock (bounded
                                          # FIFO of routing keys held)
        self._max_keys = int(max_keys)
        self._beat_thread = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Replica":
        self.server.start()
        t = threading.Thread(target=self._beat_loop, daemon=True,
                             name=f"fleet-beat-{self.id}")
        t.start()
        self._beat_thread = t
        return self

    def close(self, timeout: float = 2.0) -> None:
        with self._lock:
            self._closed = True
        self.server.stop(timeout=timeout)

    # -- heartbeats (through the ReplicaFault seams) ----------------------
    def _beat_loop(self) -> None:
        plan = self.fault_plan
        while True:
            with self._lock:
                if self._dead or self._closed:
                    return
                beat = self._beats
                self._beats += 1
            if plan is not None and plan.replica_kill(self.id, beat):
                # the abrupt death: heartbeats stop, the router fences
                # and drains us (the SIGTERM grace window)
                if self._on_down is not None:
                    self._on_down(self, "killed")
                return
            if not (plan is not None
                    and plan.replica_partitioned(self.id, beat)):
                with self._lock:
                    self.last_beat = time.perf_counter()
            delay = plan.replica_beat_delay(self.id) if plan else 0.0
            time.sleep(self.heartbeat_s + delay)

    def beats(self) -> int:
        with self._lock:
            return self._beats

    def beat_age(self) -> float:
        with self._lock:
            return time.perf_counter() - self.last_beat

    # -- liveness / load (the router's placement reads) -------------------
    def alive(self) -> bool:
        with self._lock:
            return not (self._dead or self._draining or self._closed)

    @property
    def dead(self) -> bool:
        with self._lock:
            return self._dead

    def free_slots(self) -> int:
        if not self.alive():
            return 0
        running, queued = self.server.load()
        return max(0, self.max_running - running - queued)

    # -- placement-affinity key set ---------------------------------------
    def holds(self, key: str) -> bool:
        with self._lock:
            return key in self._keys

    def note_key(self, key: str) -> None:
        if not key:
            return
        with self._lock:
            self._keys.pop(key, None)
            self._keys[key] = True
            while len(self._keys) > self._max_keys:
                self._keys.pop(next(iter(self._keys)))

    # -- migration hand-off ------------------------------------------------
    def _maybe_handoff(self, session, payload: dict) -> bool:
        """Preemption-path seam: hand the session to the router when
        this replica is going away; a plain (chaos-injected)
        preemption on a healthy replica keeps the local
        requeue-with-restore path."""
        with self._lock:
            migrating = self._draining or self._dead
        if not migrating or self._router_handoff is None:
            return False
        return self._router_handoff(session, payload, self)

    # -- drain (the migration source half) --------------------------------
    def drain(self, requeue_queued, grace_s: float = 5.0) -> None:
        """Take this replica out of service: locally queued sessions
        hand back through `requeue_queued(session, replica)`, running
        sessions get their preempt_event set (the hub checkpoints and
        the worker hands off at the next sync), and we wait out the
        grace window before closing the server."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._dead = True
        for s in self.server.queue.drain():
            if not s.is_terminal():
                requeue_queued(s, self)
        # slot holders = exactly the sessions a worker thread owns
        # (covers the pop->RUNNING window a state scan would race)
        with self.server._lock:
            live = [s for s in self.server._sessions.values()
                    if s.sid in self.server._slots
                    and not s.is_terminal()]
        for s in live:
            s.preempt_event.set()
        deadline = time.perf_counter() + float(grace_s)
        while time.perf_counter() < deadline:
            with self.server._lock:
                if self.server._running == 0:
                    break
            time.sleep(0.02)
        self.close(timeout=0.5)
