###############################################################################
# Serve-layer wire protocol (port of mpisppy_tpu/serve/protocol.py; the
# wire format is the JAX package's byte for byte, so a client of either
# package drives a server of the other).
#
# JSON lines over a Unix or TCP socket — stdlib only, one JSON object
# per newline-terminated line, both directions.  Client requests:
#
#   {"op": "submit", "tenant": "acme", "sla": "latency",
#    "model": "farmer", "num_scens": 3, "gap_target": 0.01,
#    "deadline_s": 120.0, "args": ["--crops-multiplier", "1"]}
#   {"op": "ping"}
#   {"op": "stats"}
#   {"op": "status"}     (lightweight health probe — replica id,
#                         session counts by state, queue depth, free
#                         slots, interner digests held; a fleet
#                         router's health checks ride this op)
#
# Server responses: one ack per request ({"ok": true, "session": sid}
# or {"ok": false, "error": ..., "reason": ...}), then a stream of
# per-session events scoped to THIS client's sessions:
#
#   {"event": "session-state", "session": sid, "state": "RUNNING", ...}
#   {"event": "progress", "session": sid, "iter": 7, "outer": ...,
#    "inner": ..., "rel_gap": ...}
#   {"event": "preempted", "session": sid}            (non-terminal)
#   {"event": "done", "session": sid, ...}            (terminal)
#   {"event": "failed", "session": sid, "reason": ...}(terminal)
#   {"event": "rejected", "reason": "tenant-quota", ...} (terminal)
#
# The terminal-outcome contract:
# every submitted session produces EXACTLY ONE terminal event — done,
# failed (typed reason), or rejected — never a silent hang.  A
# preemption mid-run emits the non-terminal "preempted" and the session
# resumes from its checkpoint with no client-visible state loss.
###############################################################################
from __future__ import annotations

import dataclasses
import json

#: SLA classes (the same server, two service classes).  latency = admission-priority interactive re-solves;
#: throughput = batch certification runs that fill remaining capacity.
SLA_CLASSES = ("latency", "throughput")

#: models a session may request; each maps to a model module of the port
#: the engine builds through the generic_cylinders CLI recipe surface
MODELS = {
    "farmer": "mpisppy_tpu_torch.models.farmer",
    "sslp": "mpisppy_tpu_torch.models.sslp",
    "uc": "mpisppy_tpu_torch.models.uc",
    "ccopf": "mpisppy_tpu_torch.models.ccopf",
}

#: terminal client-visible events — exactly one per session
TERMINAL_EVENTS = ("done", "failed", "rejected")

#: request ops a server answers (anything else gets a typed error line)
REQUEST_OPS = ("submit", "ping", "stats", "status")


class ProtocolError(ValueError):
    """Malformed client request — answered with a typed error line,
    never a dropped connection."""


@dataclasses.dataclass(frozen=True)
class SubmitRequest:
    """One validated session submission."""

    tenant: str
    sla: str = "throughput"
    model: str = "farmer"
    num_scens: int = 3
    gap_target: float = 0.01
    deadline_s: float | None = None
    max_iterations: int = 200
    args: tuple[str, ...] = ()
    #: rolling-horizon stream (mpc/stream.py): > 0 makes this a
    #: long-lived MPC session streaming one `step` line per window;
    #: step_deadline_s arms the PER-STEP deadline the streaming reaper
    #: enforces (consecutive-miss budget) instead of deadline_s' wall
    #: clock
    mpc_steps: int = 0
    step_deadline_s: float | None = None
    #: causal trace context (telemetry/tracecontext.py): the W3C
    #: traceparent string minted at client submit.  None/malformed =>
    #: the Session mints a fresh trace — a
    #: trace-less client still gets a fully traced request.
    traceparent: str | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "SubmitRequest":
        if not isinstance(d, dict):
            raise ProtocolError("submit payload must be an object")
        tenant = d.get("tenant")
        if not tenant or not isinstance(tenant, str):
            raise ProtocolError("submit needs a non-empty 'tenant'")
        sla = d.get("sla", "throughput")
        if sla not in SLA_CLASSES:
            raise ProtocolError(
                f"unknown sla {sla!r} (want one of {SLA_CLASSES})")
        model = d.get("model", "farmer")
        if model not in MODELS:
            raise ProtocolError(
                f"unknown model {model!r} (want one of "
                f"{tuple(MODELS)})")
        try:
            num_scens = int(d.get("num_scens", 3))
            gap = float(d.get("gap_target", 0.01))
            max_iters = int(d.get("max_iterations", 200))
        except (TypeError, ValueError) as e:
            raise ProtocolError(f"bad numeric field: {e}") from e
        if num_scens < 1:
            raise ProtocolError("num_scens must be >= 1")
        if not (0.0 < gap < 1.0):
            raise ProtocolError("gap_target must be in (0, 1)")
        ddl = d.get("deadline_s")
        if ddl is not None:
            ddl = float(ddl)
            if ddl <= 0:
                raise ProtocolError("deadline_s must be positive")
        args = d.get("args", ())
        if not isinstance(args, (list, tuple)) \
                or not all(isinstance(a, str) for a in args):
            raise ProtocolError("'args' must be a list of strings")
        try:
            mpc_steps = int(d.get("mpc_steps", 0))
        except (TypeError, ValueError) as e:
            raise ProtocolError(f"bad mpc_steps: {e}") from e
        if mpc_steps < 0:
            raise ProtocolError("mpc_steps must be >= 0")
        sddl = d.get("step_deadline_s")
        if sddl is not None:
            sddl = float(sddl)
            if sddl <= 0:
                raise ProtocolError("step_deadline_s must be positive")
        if sddl is not None and not mpc_steps:
            raise ProtocolError(
                "step_deadline_s only applies to an MPC stream "
                "(mpc_steps > 0)")
        tp = d.get("traceparent")
        if tp is not None and not isinstance(tp, str):
            raise ProtocolError("'traceparent' must be a string")
        return cls(tenant=tenant, sla=sla, model=model,
                   num_scens=num_scens, gap_target=gap, deadline_s=ddl,
                   max_iterations=max_iters, args=tuple(args),
                   mpc_steps=mpc_steps, step_deadline_s=sddl,
                   traceparent=tp)

    def to_dict(self) -> dict:
        return {"op": "submit", "tenant": self.tenant, "sla": self.sla,
                "model": self.model, "num_scens": self.num_scens,
                "gap_target": self.gap_target,
                "deadline_s": self.deadline_s,
                "max_iterations": self.max_iterations,
                "args": list(self.args),
                "mpc_steps": self.mpc_steps,
                "step_deadline_s": self.step_deadline_s,
                "traceparent": self.traceparent}


def encode(obj: dict) -> bytes:
    """One wire line.  Strict JSON (non-finite floats would emit bare
    NaN/Infinity tokens non-Python peers reject) — the same convention
    as the JSONL trace (telemetry/events._jsonable)."""
    from mpisppy_tpu_torch.telemetry.events import _jsonable
    return (json.dumps(_jsonable(obj)) + "\n").encode()


def iter_lines(sock_file):
    """Yield decoded JSON objects from a socket file object; a
    malformed line yields a ProtocolError-tagged dict instead of
    killing the reader."""
    for raw in sock_file:
        raw = raw.strip()
        if not raw:
            continue
        try:
            yield json.loads(raw)
        except ValueError:
            yield {"_malformed": raw.decode("utf-8", "replace")
                   if isinstance(raw, bytes) else str(raw)}
