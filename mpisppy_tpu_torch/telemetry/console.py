###############################################################################
# The library console (port of mpisppy_tpu/telemetry/console.py):
# global_toc goes through log().
#
# Behavior:
#   * With no telemetry configured (the default), log() prints directly
#     in global_toc's `[elapsed] msg` format to stderr — byte for byte
#     the port's output before the console existed (stdout stays the
#     CLI's result line).
#   * When a bus with a ConsoleSink is attached (telemetry.from_cfg),
#     the sink renders instead (same format, verbosity-filtered) and
#     every line ALSO lands in the JSONL trace as a CONSOLE event —
#     the console and the machine trace can never diverge.
#
# Verbosity levels: QUIET(0) errors/final results only, INFO(1) the
# default progress stream, DEBUG(2) chatty per-round diagnostics.
###############################################################################
from __future__ import annotations

import sys
import time

from mpisppy_tpu_torch.telemetry import events as ev
from mpisppy_tpu_torch.telemetry.sinks import ConsoleSink, DEBUG, INFO, QUIET

__all__ = ["log", "attach", "detach", "set_verbosity",
           "QUIET", "INFO", "DEBUG"]

_verbosity = INFO
_attached: list = []  # EventBus instances receiving CONSOLE events


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def attach(bus) -> None:
    if bus not in _attached:
        _attached.append(bus)


def detach(bus) -> None:
    if bus in _attached:
        _attached.remove(bus)


def _t0() -> float:
    import mpisppy_tpu_torch
    return mpisppy_tpu_torch._T0


def log(msg: str, level: int = INFO, cyl: str = "",
        cond: bool = True) -> None:
    """Emit one console line (and a CONSOLE event to attached buses)."""
    if not cond:
        return
    rendered = False
    for bus in list(_attached):
        out = bus.emit(ev.CONSOLE, cyl=cyl, level=level, msg=msg)
        if out is not None and any(isinstance(s, ConsoleSink)
                                   for s in bus.sinks):
            rendered = True
    if not rendered and level <= _verbosity:
        # the sink of last resort: global_toc's own format and stream
        print(f"[{time.time() - _t0():8.2f}] {msg}", file=sys.stderr,
              flush=True)
