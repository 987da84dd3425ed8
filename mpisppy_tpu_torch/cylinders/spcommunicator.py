###############################################################################
# SPCommunicator: the hub<->spoke data plane (port of
# mpisppy_tpu/cylinders/spcommunicator.py).
#
# The reference allocates MPI one-sided RMA windows of doubles with a
# write-id tail and a consensus Allreduce to detect fresh messages
# (ref:mpisppy/cylinders/spcommunicator.py:34-128,
# ref:mpisppy/cylinders/hub.py:379-445, spoke.py:63-122).  All of that
# machinery exists to move small dense vectors (W, nonants, scalar
# bounds, a kill flag) between PROCESSES.
#
# Here hub and spokes live in ONE process driving one device mesh, so the
# "window" is a plain host-side mailbox of tensors with a write
# counter.  The asynchrony the reference gets from RMA windows we get
# from asynchronous kernel launches: a spoke's `update` launches device
# work and returns immediately; the hub only waits on its results when
# it reads the bound.  Freshness = compare write ids — same
# semantics, no locks, no consensus protocol needed (single host thread).
#
# Wire format parity (ref:mpisppy/cylinders/hub.py:586-616): hub
# publishes {"W": (S,N), "nonants": (S,N), "xbar": (nodes,N), "bounds":
# (outer, inner)}; spokes publish {"bound": scalar} or {"nonants": ...}.
###############################################################################
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Mailbox:
    """One-directional message slot with freshness tracking
    (the RMA window + write_id analog, ref:spcommunicator.py:100-128)."""

    payload: Any = None
    write_id: int = 0

    def put(self, payload: Any):
        self.payload = payload
        self.write_id += 1

    def fresh_for(self, last_seen: int) -> bool:
        return self.write_id > last_seen


class SPCommunicator:
    """Base for hub and spoke communicators
    (ref:mpisppy/cylinders/spcommunicator.py:34).

    Lifecycle hooks mirror the reference: make_windows() allocates the
    mailboxes, main() runs the algorithm, sync() exchanges data,
    is_converged() decides termination, finalize() returns the last
    result.
    """

    def __init__(self, opt, options: dict | None = None):
        self.opt = opt
        self.options = options or {}
        self.to_hub = Mailbox()
        self.from_hub = Mailbox()
        self._last_seen_hub = 0
        self._kill = False

    # -- window lifecycle (no-ops kept for API parity) --------------------
    def make_windows(self):
        pass

    def free_windows(self):
        pass

    # -- messaging --------------------------------------------------------
    def got_kill_signal(self) -> bool:
        """ref:mpisppy/cylinders/spoke.py:124-128 (write_id == -1)."""
        return self._kill

    def send_terminate(self):
        """ref:mpisppy/cylinders/hub.py:447-459."""
        self._kill = True

    def hub_update(self) -> Any | None:
        """Fresh hub payload or None (spoke_from_hub analog)."""
        if self.from_hub.fresh_for(self._last_seen_hub):
            self._last_seen_hub = self.from_hub.write_id
            return self.from_hub.payload
        return None

    # -- hooks ------------------------------------------------------------
    def main(self):
        raise NotImplementedError

    def sync(self):
        pass

    def is_converged(self) -> bool:
        return False

    def finalize(self):
        return None

    def hub_finalize(self):
        pass
