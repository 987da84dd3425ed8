###############################################################################
# Tensors on their way to the host without waiting for the card.
#
# The wheel reads device results one step behind (the fused wheel's packed
# scalars, the async wheel's theta, the kernel counters) and checkpoints
# its state from a background thread.  Each needs the same thing: start
# the device-to-host copies now, on the launching thread, and read them
# later.  HostCopy copies CUDA tensors into pinned memory with
# non_blocking=True and records one event after them, so values() waits
# for those copies only — never for work launched afterwards — and the
# copies, queued on the stream before any later launch, read the tensors
# as they are now.  CPU tensors are held by reference: no step writes a
# solver, PH or wheel state tensor in place.
###############################################################################
from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A list of tensors on their way to the host."""

    def __init__(self, tensors):
        self.parts, self.event = [], None
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t = h
                if self.event is None:
                    self.event = torch.cuda.Event()
            self.parts.append(t)
        if self.event is not None:
            self.event.record()

    def values(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [p.numpy() for p in self.parts]
