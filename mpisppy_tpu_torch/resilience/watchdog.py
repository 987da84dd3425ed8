###############################################################################
# Hub progress watchdog (port of mpisppy_tpu/resilience/watchdog.py).
#
# A long-lived wheel can wedge in ways no exception ever reports: a
# hung device launch, a wedged exchange, a starved dispatcher — the hub
# loop simply stops advancing and the process sits there burning
# reservation.  The reference never needs this (a hung Gurobi rank
# trips MPI timeouts); a single-process wheel must supervise itself.
#
# HubWatchdog is a daemon thread fed host-side progress beats from the
# hub (`beat(iter, outer, inner)` once per sync — progress = the hub
# iteration advanced OR a certified bound moved).  When no progress
# lands for `budget_s` wall seconds it TRIPS:
#
#   1. emit a `watchdog` telemetry event + bump watchdog_trips_total;
#   2. dump every flight recorder on the hub's bus (the black box shows
#      what the wheel was doing when it froze);
#   3. act, per `action`:
#        'degrade' — switch the process-default dispatch scheduler to
#                    direct un-coalesced dispatch (coalescing windows /
#                    admission timers out of the suspect path) and keep
#                    watching; a SECOND full budget with no progress
#                    escalates to the abort action below;
#        'abort'   — a last-gasp emergency checkpoint when the hub has
#                    a checkpoint_path (hub.emergency_checkpoint), then
#                    exit 75 (EX_TEMPFAIL, the code a preemption exits
#                    with) so the pool scheduler restarts the run and
#                    --checkpoint-restore resumes it.
#
# While healthy the thread reads host state only (never a tensor, never
# torch.cuda.synchronize) and costs one monotonic-clock read per
# `interval_s`; only the abort's save reads the state's tensors (a save
# behind a hung launch waits on it, as in the JAX package).  The abort
# path deliberately writes its last words straight to stderr: the
# telemetry console may be wedged inside the very stall being escaped.
###############################################################################
from __future__ import annotations

import os
import sys
import threading
import time


class HubWatchdog:
    """Supervise hub progress; see the module header.

    `hub` is duck-typed: telemetry (bus), run_id.  `abort_fn` is
    injectable for tests (default os._exit — a hung process cannot be
    unwound politely).  The JAX watchdog's 'shrink' rung (re-home onto
    a survivor mesh) waits for the multi-GPU slice."""

    def __init__(self, hub, budget_s: float, action: str = "abort",
                 interval_s: float | None = None, abort_fn=None):
        if action not in ("abort", "degrade"):
            raise ValueError(f"unknown watchdog action {action!r}")
        self.hub = hub
        self.budget_s = float(budget_s)
        self.action = action
        self.interval_s = max(0.01, float(interval_s)) \
            if interval_s is not None else max(0.05, self.budget_s / 4.0)
        self.abort_fn = abort_fn or os._exit
        # trips/degraded are touched only on the supervisor thread
        # (and read by tests after stop()); the beat path shares only
        # the two _lock-guarded fields below
        self.trips = 0
        self.degraded = False
        self._lock = threading.Lock()
        self._last_progress = time.perf_counter()  # guarded-by: _lock
        self._last = (None, None, None)            # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- the hub-facing surface -------------------------------------------
    def start(self) -> "HubWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="mpisppy-torch-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def beat(self, hub_iter: int, outer: float, inner: float) -> None:
        """One host-side progress report per hub sync.  Progress = the
        iteration advanced or either certified bound moved; a hung
        wheel simply stops calling this, and a wheel whose sync loop
        still spins without moving anything resets the budget via the
        advancing iteration count (stall-without-hang is the hub's own
        max_stalled_iters termination's job, not the watchdog's)."""
        cur = (hub_iter, outer, inner)
        with self._lock:
            if cur != self._last:
                self._last = cur
                self._last_progress = time.perf_counter()

    def stalled_s(self) -> float:
        with self._lock:
            return time.perf_counter() - self._last_progress

    # -- the supervisor loop ----------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            stalled = self.stalled_s()
            if stalled < self.budget_s:
                continue
            self._trip(stalled)
            if self._stop.is_set():
                return
            with self._lock:   # fresh budget after any surviving action
                self._last_progress = time.perf_counter()

    def _trip(self, stalled: float) -> None:
        # stop() racing an in-flight trip wins: the wheel is unwinding
        # or finalizing on purpose and must not be exited from under
        if self._stop.is_set():
            return
        self.trips += 1
        # escalation ladder: 'abort' goes straight there; 'degrade'
        # gives one degraded budget first
        rung = "abort" if self.action == "abort" or self.degraded \
            else "degrade"
        self._emit(action=rung, stalled_s=round(stalled, 3),
                   budget_s=self.budget_s, trips=self.trips)
        try:
            from mpisppy_tpu_torch.telemetry import metrics as _metrics
            _metrics.REGISTRY.inc("watchdog_trips_total")
        except Exception:
            pass
        self._dump_flight(stalled)
        if rung == "abort":
            self._abort(stalled)
        else:
            self._degrade()

    def _emit(self, **data) -> None:
        bus = getattr(self.hub, "telemetry", None)
        if bus is None:
            return
        try:
            from mpisppy_tpu_torch import telemetry as tel
            bus.emit(tel.WATCHDOG, run=getattr(self.hub, "run_id", ""),
                     cyl="watchdog", component="hub", **data)
        except Exception:
            pass

    def _dump_flight(self, stalled: float) -> None:
        try:
            from mpisppy_tpu_torch.telemetry import flightrec
            bus = getattr(self.hub, "telemetry", None)
            flightrec.dump_all(
                bus, reason=f"watchdog: no hub progress for "
                            f"{stalled:.1f}s (budget {self.budget_s}s)")
        except Exception:
            pass

    def _degrade(self) -> None:
        """Switch the process-default dispatch scheduler to direct,
        un-coalesced dispatch — the admission/coalescing machinery is
        out of the suspect path, every later submit dispatches solo."""
        self.degraded = True
        try:
            from mpisppy_tpu_torch import dispatch as _dispatch
            sched = _dispatch.get_scheduler(create=False)
            if sched is not None:
                sched.degrade()
        except Exception:
            pass
        try:
            from mpisppy_tpu_torch.telemetry import console as _console
            _console.log("watchdog: hub stalled past budget — degraded "
                         "dispatch to direct un-coalesced mode")
        except Exception:
            pass

    def _abort(self, stalled: float) -> None:
        """Checkpoint-and-abort: a last-gasp save when the hub has a
        checkpoint_path, then EX_TEMPFAIL so the pool scheduler restarts
        the run and --checkpoint-restore resumes it."""
        if self._stop.is_set():   # re-check: stop() may have landed
            return                # while the trip was dumping
        path = None
        try:
            path = (getattr(self.hub, "options", None) or {}).get(
                "checkpoint_path")
            if path:
                self.hub.emergency_checkpoint(path)
        except Exception:
            path = None
        # stderr on purpose: the console bus may be part of the wedge
        print(f"watchdog: ABORT — no hub progress for {stalled:.1f}s "
              f"(budget {self.budget_s}s); "
              f"{'checkpoint saved to ' + path if path else 'no checkpoint path'}"
              f"; exiting 75", file=sys.stderr, flush=True)
        self._stop.set()
        self.abort_fn(75)
