###############################################################################
# CompileWatch: the process-wide compile counter (port of
# mpisppy_tpu/dispatch/compilewatch.py).
#
# The JAX package counts XLA backend compiles through jax.monitoring.
# PyTorch eager has no backend compile; what a recompile costs here is
#   * the first build or load of the port's kernel library in a process
#     (ops/pdhg_window.py builds at first use: nvcc for every source,
#     then a ctypes load), recorded with its seconds, and
#   * the first dispatch of a padded shape signature (dispatch/
#     scheduler.py; dispatch/buckets.shape_signature), the analog of a
#     jit specialization, recorded with 0 seconds.
# Everything downstream reads deltas of the monotone count.
###############################################################################
from __future__ import annotations

import threading

_lock = threading.Lock()
_count = 0
_seconds = 0.0
_signatures: set = set()


def record(seconds: float = 0.0) -> None:
    """Count one compile event taking `seconds`."""
    global _count, _seconds
    with _lock:
        _count += 1
        _seconds += float(seconds)


def note_signature(sig) -> bool:
    """Count a padded shape signature the first time this process
    dispatches it; returns whether it was new."""
    global _count
    with _lock:
        if sig in _signatures:
            return False
        _signatures.add(sig)
        _count += 1
        return True


class CompileWatch:
    """Delta view over the global counter: `with CompileWatch() as w`
    or manual mark()/delta()."""

    def __init__(self):
        self._mark = 0
        self.mark()

    @staticmethod
    def total() -> int:
        with _lock:
            return _count

    @staticmethod
    def total_seconds() -> float:
        with _lock:
            return _seconds

    def mark(self) -> None:
        self._mark = self.total()

    def delta(self) -> int:
        """Compile events since the last mark()."""
        return self.total() - self._mark

    def __enter__(self):
        self.mark()
        return self

    def __exit__(self, *exc):
        return False
