###############################################################################
# Back-compat views: the in-memory trace surfaces
# (`Hub.trace` list of per-iteration dict rows, `Spoke.trace` list of
# (hub_iter, bound) tuples) are now SUBSCRIBERS of the event bus — one
# spine, with the legacy lists as a derived view (port of
# mpisppy_tpu/telemetry/views.py).  chip_smoke.py and the tests keep
# reading the lists unchanged; a row's `t` is its event's t_mono.
###############################################################################
from __future__ import annotations

from mpisppy_tpu_torch.telemetry import events as ev
from mpisppy_tpu_torch.telemetry.sinks import Sink


class WheelTraceView(Sink):
    """Maintains one hub's legacy trace lists from its event stream.

    Run-scoped: events carry the emitting hub's run id, so several
    wheels sharing one bus (or one configured global bus) can never
    cross-pollinate each other's lists."""

    def __init__(self, hub):
        self._hub = hub

    def handle(self, event: ev.Event) -> None:
        hub = self._hub
        if event.run != hub.run_id:
            return
        if event.kind == ev.HUB_ITERATION:
            row = dict(event.data)
            row["t"] = event.t_mono
            hub.trace.append(row)
        elif event.kind == ev.BOUND_ACCEPT:
            j = event.data.get("spoke")
            if j is not None and 0 <= j < len(hub.spokes):
                hub.spokes[j].trace.append(
                    (event.hub_iter, event.data.get("bound")))
