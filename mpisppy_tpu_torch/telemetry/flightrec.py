###############################################################################
# Flight recorder: the wheel's black box (port of
# mpisppy_tpu/telemetry/flightrec.py).
#
# A FlightRecorder is a bounded in-memory ring sink holding the LAST
# `capacity` (default 512) events of the stream.  It is registered by
# generic_cylinders on every decomposition run — including runs with
# --trace-jsonl OFF — and costs one slot store per event in steady
# state: the ring is preallocated at construction and only holds
# references to Event objects the bus already built, so a full ring
# never allocates (the deque-with-maxlen semantics without the node
# churn).
#
# When the wheel dies — PreemptionError (real signal or a FaultPlan
# trip), or any unhandled exception unwinding WheelSpinner.spin — the
# recorder dumps its window ATOMICALLY to `flight-<runid>.jsonl`: a
# `flight-recorder` header line (reason, drop count), then the buffered
# events as ordinary trace lines, oldest first.  The JAX package's
# analyzer reads a flight dump exactly like a full --trace-jsonl
# stream (`python -m mpisppy_tpu.telemetry analyze`).
###############################################################################
from __future__ import annotations

import json
import os
import threading
import time

from mpisppy_tpu_torch.telemetry import events as ev
from mpisppy_tpu_torch.telemetry.sinks import Sink

DEFAULT_CAPACITY = 512

#: header line kind (NOT a bus event kind: it exists only in dump files)
HEADER_KIND = "flight-recorder"


class FlightRecorder(Sink):
    """Bounded ring of the last `capacity` events, dumpable on crash."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: str = "."):
        self.capacity = max(1, int(capacity))
        self.dump_dir = dump_dir
        # handle() can run on the watchdog or dispatcher thread while
        # dump() runs on the crash path of the main thread — without
        # this lock a dump racing an emit could tear the ring snapshot
        # (duplicate the newest event into the oldest slot, drop the
        # true oldest).
        self._lock = threading.Lock()
        self._ring: list = [None] * self.capacity   # guarded-by: _lock
        self._count = 0          # total events seen  # guarded-by: _lock
        self._run = ""           # last non-empty run  # guarded-by: _lock
        self.dumped_to: str | None = None  # last dump path (crash-path
                                           # thread only; read by tests
                                           # after the dump)

    # -- sink interface ---------------------------------------------------
    def handle(self, event: ev.Event) -> None:
        with self._lock:
            self._ring[self._count % self.capacity] = event
            self._count += 1
            if event.run:
                self._run = event.run

    # -- inspection -------------------------------------------------------
    def events(self) -> list:
        """Buffered events, oldest first (a consistent snapshot)."""
        with self._lock:
            n = min(self._count, self.capacity)
            start = self._count - n
            return [self._ring[i % self.capacity]
                    for i in range(start, self._count)]

    @property
    def run(self) -> str:
        with self._lock:
            return self._run or "unknown"

    @property
    def dropped(self) -> int:
        """Events that fell off the ring (seen minus buffered)."""
        with self._lock:
            return max(0, self._count - self.capacity)

    # -- the black-box dump -----------------------------------------------
    def dump(self, reason: str = "", path: str | None = None) -> str:
        """Write `flight-<runid>.jsonl` atomically (tmp + rename) and
        return its path.  Never raises: a crash handler is the worst
        place to add a second failure — on any error the best-effort
        path (or "") comes back and the original exception keeps
        propagating in the caller."""
        try:
            from mpisppy_tpu_torch.utils.atomic_io import atomic_write_text
            if path is None:
                path = os.path.join(self.dump_dir,
                                    f"flight-{self.run}.jsonl")
            buffered = self.events()
            header = json.dumps({
                "kind": HEADER_KIND, "run": self.run, "reason": reason,
                "t_wall": time.time(), "capacity": self.capacity,
                "dumped_events": len(buffered), "dropped": self.dropped,
            })
            lines = [header] + [e.to_json() for e in buffered]
            atomic_write_text(path, "\n".join(lines) + "\n")
            self.dumped_to = path
            return path
        except Exception:
            return self.dumped_to or ""


def recorders_on(bus) -> list[FlightRecorder]:
    """The FlightRecorder sinks subscribed to `bus` ([] for None)."""
    if bus is None:
        return []
    return [s for s in bus.sinks if isinstance(s, FlightRecorder)]


def dump_all(bus, reason: str = "") -> list[str]:
    """Dump every recorder on `bus`; returns the written paths."""
    return [r.dump(reason=reason) for r in recorders_on(bus)]
