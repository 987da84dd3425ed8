###############################################################################
# Pluggable event sinks (port of mpisppy_tpu/telemetry/sinks.py).
#
#   JsonlSink            — one JSON object per line; the machine trace.
#   ConsoleSink          — renders CONSOLE events for humans (verbosity-
#                          filtered) on stderr, in global_toc's format
#                          (telemetry/console.py routes through it when
#                          one is attached); stdout stays the CLI's
#                          result line.
#   MetricsSnapshotSink  — periodically (and on close) rewrites a
#                          Prometheus text-exposition file ATOMICALLY
#                          from a MetricsRegistry, for long-running runs
#                          where tailing a JSONL stream is the wrong
#                          tool.  Also folds per-event counts
#                          (events_total{kind=...}) into the registry.
#
# A sink must never raise into the wheel: EventBus.emit guards every
# handle() call and detaches a sink after repeated failures.
###############################################################################
from __future__ import annotations

import sys
import time

from mpisppy_tpu_torch.telemetry import events as ev
from mpisppy_tpu_torch.telemetry import metrics as metrics_mod
from mpisppy_tpu_torch.utils.atomic_io import atomic_write_text


class Sink:
    """Subscriber interface: handle(event) per event, close() once."""

    def handle(self, event: ev.Event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """Append events to a JSONL trace file (wall + monotonic timestamps,
    run/cylinder ids — see Event.to_dict for the line schema).  The file
    is opened lazily in APPEND mode — a preempted run restarted with
    --checkpoint-restore and the same --trace-jsonl path continues the
    stream instead of truncating the pre-preemption history (run ids
    delimit the segments) — and flushed per line, so a crashed run's
    trace is complete up to the crash."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def handle(self, event: ev.Event) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(event.to_json() + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# console verbosity levels (CONSOLE event `level` field)
QUIET, INFO, DEBUG = 0, 1, 2


class ConsoleSink(Sink):
    """Human console: prints CONSOLE events whose level clears the
    verbosity bar, in global_toc's `[elapsed] msg` format, to stderr
    unless given a stream."""

    def __init__(self, verbosity: int = INFO, stream=None, t0=None):
        self.verbosity = int(verbosity)
        self.stream = stream
        if t0 is None:
            # anchor at process start like global_toc, not at sink
            # construction — the [elapsed] column must not reset when
            # telemetry attaches mid-process
            try:
                import mpisppy_tpu_torch
                t0 = mpisppy_tpu_torch._T0
            except Exception:
                t0 = time.time()
        self._t0 = t0

    def handle(self, event: ev.Event) -> None:
        if event.kind != ev.CONSOLE:
            return
        level = INFO if event.level is None else event.level
        if level > self.verbosity:
            return
        stream = self.stream or sys.stderr
        msg = event.data.get("msg", "")
        print(f"[{event.t_wall - self._t0:8.2f}] {msg}", file=stream,
              flush=True)


class MetricsSnapshotSink(Sink):
    """Atomic Prometheus-style text snapshot of a MetricsRegistry.

    Rewrites `path` at most every `every_s` seconds (piggybacked on the
    event stream — no extra thread) and always on close(), via the
    shared atomic-write helper so a scraper never reads a torn file.
    Each event also bumps events_total{kind} so the snapshot reflects
    stream activity even before any kernel counters land."""

    def __init__(self, path: str, registry=None, every_s: float = 30.0):
        self.path = path
        self.registry = registry if registry is not None \
            else metrics_mod.REGISTRY
        self.every_s = float(every_s)
        self._last_write = 0.0

    def handle(self, event: ev.Event) -> None:
        self.registry.inc("events_total", kind=event.kind)
        now = time.perf_counter()
        if now - self._last_write >= self.every_s:
            self._last_write = now
            self.write_snapshot()

    def write_snapshot(self) -> None:
        atomic_write_text(self.path, self.registry.render_prom())

    def close(self) -> None:
        self.write_snapshot()
