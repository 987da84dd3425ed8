###############################################################################
# Causal trace context — the W3C-traceparent-shaped identity every event
# carries from client submit to device kernel (port of
# mpisppy_tpu/telemetry/tracecontext.py).
#
# A TraceContext is the (trace_id, span_id, parent_span_id) triple:
#
#   * trace_id   — 32 hex chars, minted ONCE at client submit (loadgen,
#     an external client's `traceparent` field) or, for traffic that
#     arrives without one, by the first Session that sees the request.
#     Every event of every hop of that request — router placement,
#     replica run segments, hub sync, dispatch megabatch attribution,
#     mesh reshard rebuilds, MPC windows — carries the SAME trace_id.
#   * span_id    — 16 hex chars naming the current causal span.  Spans
#     are implicit intervals: an event *belongs to* the span whose id it
#     carries, and the span's extent is the [min, max] wall-clock of its
#     events (torn-tail safe — no close record is required, so a crashed
#     segment still renders).  `span-start` events add names/attributes.
#   * parent_span_id — the causal edge.  A migration hand-off detaches
#     the source segment span; the restore on the destination parents a
#     NEW segment under the same root, so the gap between the two
#     segments IS the migration gap on the critical path.
#
# The wire form is the W3C traceparent header shape
# (`00-<trace>-<span>-01`), carried as a first-class SubmitRequest
# field; the event-row form is three top-level JSONL keys
# (`trace_id`/`span_id`/`parent_span_id`, omitted when absent so
# pre-trace rows are valid rows of the same schema).  Stdlib only.
###############################################################################
from __future__ import annotations

import dataclasses
import uuid

_VERSION = "00"


def _hex(n: int) -> str:
    h = uuid.uuid4().hex
    while len(h) < n:
        h += uuid.uuid4().hex
    return h[:n]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One causal position: the trace, the current span, and its
    parent edge.  Immutable — every hop derives a child instead of
    mutating, so two threads sharing a context can never race it."""

    trace_id: str
    span_id: str
    parent_span_id: str = ""

    @staticmethod
    def mint() -> "TraceContext":
        """A fresh root: new trace, new root span, no parent."""
        return TraceContext(trace_id=_hex(32), span_id=_hex(16))

    def child(self) -> "TraceContext":
        """A new span under this one (same trace)."""
        return TraceContext(trace_id=self.trace_id, span_id=_hex(16),
                            parent_span_id=self.span_id)

    # -- wire form (SubmitRequest.traceparent) ----------------------------
    def to_traceparent(self) -> str:
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-01"

    @staticmethod
    def from_traceparent(s) -> "TraceContext | None":
        """Parse the wire form; None on anything malformed — a client
        sending garbage gets a freshly minted trace, never an error."""
        if not isinstance(s, str):
            return None
        parts = s.strip().split("-")
        if len(parts) != 4:
            return None
        _ver, trace_id, span_id, _flags = parts
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        if set(trace_id) == {"0"} or set(span_id) == {"0"}:
            return None    # all-zero ids are invalid per W3C
        return TraceContext(trace_id=trace_id, span_id=span_id)
