###############################################################################
# mpisppy_tpu_torch: the PyTorch / CUDA port of mpisppy_tpu.
#
# Same layout and names as the JAX package (ops/, core/, algos/,
# cylinders/, models/, dispatch/, spin_the_wheel.py), written as plain
# functions on torch tensors.  The JAX package stays the reference; this
# package imports neither it nor JAX.
#
# Device policy: entry points that create tensors (core.batch.from_specs,
# ops.boxqp.make_boxqp) run on CUDA unless the caller passes
# device="cpu"; without CUDA they raise instead of falling back.
# Everything downstream follows the device of the tensors it is given.
# Scoring matmuls run in IEEE f32 (TF32 is switched off here, at import,
# and again whenever a CUDA device is resolved).
###############################################################################
import time as _time

import torch

__version__ = "0.1.0"

_T0 = _time.time()

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for something else.  Raises when CUDA is wanted but absent — a run
    meant for the card must never land on the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def global_toc(msg: str, cond: bool = True) -> None:
    """Timestamped progress logging (ref:mpisppy/__init__.py:16-22),
    routed through the telemetry console (telemetry/console.py): with no
    telemetry configured it prints `[elapsed] msg` to stderr as before;
    with a configured bus every line also lands in the JSONL trace."""
    if cond:
        from mpisppy_tpu_torch.telemetry import console
        console.log(msg)
