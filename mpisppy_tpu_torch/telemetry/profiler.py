###############################################################################
# Profiler hooks (port of annotate/step of mpisppy_tpu/telemetry/
# profiler.py).
#
# annotate(name) / step(name, n) are torch.profiler.record_function
# ranges that never raise: the wheel brackets its phases (hub sync,
# harvest, spoke update, the async exchange halves), so a profile taken
# around a run (chip_smoke.py's profile phases) shows named host ranges
# beside the kernels.  Outside an active profiler a range costs a few
# microseconds of host work.  The --profile-dir session waits for the
# telemetry slice (ROADMAP.md queue A, item 10).
###############################################################################
from __future__ import annotations

import contextlib


def annotate(name: str):
    """Named host range (shows in a torch.profiler trace)."""
    try:
        import torch
        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()


def step(name: str, step_num: int):
    """One wheel iteration as a named range `name#step_num`, keyed by
    hub iteration."""
    return annotate(f"{name}#{int(step_num)}")
