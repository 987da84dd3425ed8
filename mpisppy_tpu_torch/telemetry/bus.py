###############################################################################
# EventBus: the wheel's one reporting spine (port of
# mpisppy_tpu/telemetry/bus.py).
#
# Emitters (hub, fault plan, kernel harvest, console) publish typed
# events; subscribers (JSONL trace, console, metrics snapshot, the
# back-compat trace-list views) each see the full ordered stream.
# Design points:
#
#   * Thread-safe: the watchdog and the dispatch scheduler emit from
#     their own threads while the hub loop emits on the main thread; a
#     lock serializes sequence numbering and sink fan-out.
#   * Failure-isolated: a sink that raises is detached after
#     MAX_SINK_ERRORS consecutive failures — telemetry must never kill
#     (or wedge) the wheel it observes.
#   * Cheap when idle: a bus with no subscribers never constructs an
#     Event object, so library code can emit unconditionally.
###############################################################################
from __future__ import annotations

import threading

from mpisppy_tpu_torch.telemetry import events as ev

MAX_SINK_ERRORS = 3


class EventBus:
    def __init__(self):
        # sequence numbering and sink fan-out are serialized by _lock
        self._lock = threading.Lock()
        self._sinks: list = []             # guarded-by: _lock
        self._errors: dict[int, int] = {}  # guarded-by: _lock
        self._seq = 0                      # guarded-by: _lock
        self._trace = None                 # guarded-by: _lock
        self.closed = False                # guarded-by: _lock

    # -- trace scoping (telemetry/tracecontext.py) --------------
    def set_trace(self, ctx) -> None:
        """Scope the bus to a TraceContext: every subsequent emit is
        stamped with its (trace_id, span_id, parent_span_id) unless the
        emit passes an explicit `trace=`.  None clears the scope.  A
        per-session bus is scoped to the session's current segment
        span; a shared server/router bus stays unscoped and stamps
        per-emit."""
        with self._lock:
            self._trace = ctx

    @property
    def trace(self):
        """The current default TraceContext (None when unscoped)."""
        with self._lock:
            return self._trace

    # -- subscription -----------------------------------------------------
    def subscribe(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def unsubscribe(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
            self._errors.pop(id(sink), None)

    @property
    def sinks(self) -> tuple:
        with self._lock:
            return tuple(self._sinks)

    # -- emission ---------------------------------------------------------
    def emit(self, kind: str, *, run: str = "", cyl: str = "",
             hub_iter: int | None = None, level: int | None = None,
             trace=None, **data) -> ev.Event | None:
        """Publish one event to every subscriber.  Returns the Event (or
        None when nobody is listening — the no-telemetry fast path).
        `trace=` overrides the bus-scoped TraceContext for this one
        event (the shared-bus attribution path)."""
        with self._lock:
            if not self._sinks or self.closed:
                return None
            self._seq += 1
            event = ev.make_event(kind, self._seq, run=run, cyl=cyl,
                                  hub_iter=hub_iter, level=level,
                                  trace=(trace if trace is not None
                                         else self._trace),
                                  data=data)
            dead = []
            last_err: dict[int, BaseException] = {}
            for sink in self._sinks:
                try:
                    sink.handle(event)
                    self._errors.pop(id(sink), None)
                except Exception as e:
                    n = self._errors.get(id(sink), 0) + 1
                    self._errors[id(sink)] = n
                    last_err[id(sink)] = e
                    if n >= MAX_SINK_ERRORS:
                        dead.append(sink)
            for sink in dead:
                self._sinks.remove(sink)
                # drop the stale count: a later sink object can reuse
                # this id (CPython address reuse) and must start at 0
                self._errors.pop(id(sink), None)
        # warn OUTSIDE the lock, and never through console.log (an
        # attached bus would re-enter emit on this non-reentrant lock):
        # a silently vanishing --trace-jsonl artifact is worse than a
        # stderr line
        for sink in dead:
            import sys
            e = last_err.get(id(sink))
            sys.stderr.write(
                f"[telemetry] detached sink {type(sink).__name__} after "
                f"{MAX_SINK_ERRORS} consecutive failures "
                f"({type(e).__name__ if e else '?'}: {e})\n")
        return event

    def close(self) -> None:
        """Flush + detach every sink; the bus then drops all events."""
        with self._lock:
            sinks, self._sinks = self._sinks, []
            self.closed = True
        for sink in sinks:
            try:
                sink.close()
            except Exception:
                pass
