###############################################################################
# Typed telemetry events — the vocabulary of the wheel's one reporting
# spine (port of mpisppy_tpu/telemetry/events.py; the kinds, the field
# names and the JSONL line layout are the JAX package's, unchanged).
#
# Every observable thing the wheel does maps to exactly one event kind;
# sinks (telemetry/sinks.py) and back-compat views (the hub's `trace`
# list, a spoke's `(iter, bound)` trace) are all subscribers of the same
# EventBus stream.  An Event is a frozen host-side record: wall-clock
# AND monotonic timestamps (wall for correlating across machines,
# monotonic for durations — wall clocks step), a per-bus sequence
# number (total order even when two events land in the same clock
# tick), the run id, and the producing cylinder.
###############################################################################
from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Any

# -- event taxonomy ---------------------------------------------------------
HUB_ITERATION = "hub-iteration"        # one hub sync: bounds, gaps, conv
SPOKE_HARVEST = "spoke-harvest"        # a spoke produced a (raw) bound
BOUND_ACCEPT = "bound-accept"          # harvested bound passed validation
BOUND_REJECT = "bound-reject"          # non-finite / sense-violating bound
SPOKE_STRIKE = "spoke-strike"          # unambiguous garbage charged a strike
SPOKE_DISABLE = "spoke-disable"        # strike budget exhausted
BOUND_EVICT = "bound-evict"            # contradicted incumbent evicted
CHECKPOINT_WRITE = "checkpoint-write"  # a snapshot landed on disk
CHECKPOINT_RESTORE = "checkpoint-restore"
FAULT_INJECTED = "fault-injected"      # a FaultPlan seam fired
LANE_QUARANTINE = "lane-quarantine"    # PDHG lane guard reset lanes
DISPATCH = "dispatch"                  # one coalesced megabatch dispatched
DISPATCH_RETRY = "dispatch-retry"      # a failed/hung dispatch re-tried
DISPATCH_QUARANTINE = "dispatch-quarantine"  # a poisoned request isolated
                                       # by bisection; its ticket resolves
                                       # with a typed SolveFailed
WATCHDOG = "watchdog"                  # a supervisor tripped / acted
                                       # (hub progress stall, dispatcher
                                       # thread death)
PLANE_WRITE = "plane-write"            # async hub: host wrote an
                                       # exchange-plane slot (slot,
                                       # generation, staleness)
EXCHANGE_OVERLAP = "exchange-overlap"  # async hub: per-sync host
                                       # exchange attribution (issue_s,
                                       # complete_s, staleness, theta)
SESSION_STATE = "session-state"        # serve layer: a session moved
                                       # through its lifecycle (QUEUED/
                                       # ADMITTED/RUNNING/DEGRADED/
                                       # DONE/FAILED/REJECTED)
ADMISSION_REJECTED = "admission-rejected"  # serve layer: backpressure
                                       # refused a submit with a typed
                                       # reason (queue-full / quota /
                                       # draining) — never a hang
FLEET_PLACEMENT = "fleet-placement"    # fleet router: a session placed
                                       # on a replica (policy: affinity
                                       # on the interner routing key,
                                       # else least-loaded)
SESSION_MIGRATED = "session-migrated"  # fleet router: a session moved
                                       # replicas (emergency checkpoint
                                       # -> requeue -> restore on the
                                       # destination; non-terminal)
REPLICA_STATE = "replica-state"        # fleet health plane: a replica
                                       # moved UP/SUSPECT/DEAD/DRAINED
MESH_STATE = "mesh-state"              # elastic mesh membership: a host
                                       # moved UP/SUSPECT/DEAD, with the
                                       # epoch that observed the move
                                       # (parallel/elastic.py)
MESH_HOST_LOST = "mesh-host-lost"      # elastic mesh: a host went
                                       # sticky-DEAD and its shard is
                                       # orphaned — a reshard follows
MESH_RESHARD = "mesh-reshard"          # elastic mesh: the wheel was
                                       # re-partitioned across the
                                       # survivor set (old/new device
                                       # counts, epoch, hub_iter)
MESH_STRAGGLER = "mesh-straggler"      # elastic mesh: a hub-harvest
                                       # fetch missed its deadline or
                                       # tore; typed MeshDegraded (or a
                                       # clean re-fetch), never a hang
MPC_STEP = "mpc-step"                  # rolling-horizon stream: one
                                       # window solved (step, rel_gap,
                                       # warm/cold, latency_s) —
                                       # mirrors the client's `step`
                                       # line (mpc/stream.py)
MPC_DEGRADED = "mpc-degraded"          # a window missed its gap target
                                       # warm AND cold (typed
                                       # StepDegraded; the stream
                                       # continues on the best iterate)
SCENGEN = "scengen"                    # a VirtualBatch was built: the
                                       # program, scenario count, base
                                       # seed, and the resident-vs-
                                       # materialized byte accounting
                                       # (docs/scengen.md)
KERNEL_COUNTERS = "kernel-counters"    # on-device counter harvest
CONSOLE = "console"                    # a human-readable log line
PROFILE = "profile"                    # profiler lifecycle: "start", or
                                       # "captured" + trace_dir once a
                                       # capture is VERIFIED on disk
                                       # (analyze auto-discovery key)
SPAN = "span"                          # one timed wheel phase (host wall)
SPAN_START = "span-start"              # causal tracing: a new
                                       # named span opened under the
                                       # row's trace context — segments
                                       # (one per run attempt/replica),
                                       # mesh reshard rebuilds, MPC
                                       # windows.  Spans need no close
                                       # record: their extent is the
                                       # [min, max] wall clock of the
                                       # rows carrying their span_id
                                       # (torn-tail safe)
SLO_OBSERVATION = "slo-observation"    # one terminal SLO sample for a
                                       # session: SLA class, outcome,
                                       # client-observed total wall,
                                       # migrations/preemptions, step
                                       # deadline misses (slo.py folds
                                       # these into error budgets)
RUN_START = "run-start"
RUN_END = "run-end"                    # exit reason + final gap

ALL_KINDS = frozenset(v for k, v in list(globals().items())
                      if k.isupper() and isinstance(v, str))


def new_run_id() -> str:
    """Short unique id correlating every event of one wheel run."""
    return uuid.uuid4().hex[:12]


def _jsonable(v: Any) -> Any:
    """Best-effort conversion to something json.dumps accepts.  Device
    scalars/arrays become Python numbers/lists; anything exotic falls
    back to repr — a trace line must never raise."""
    if isinstance(v, float):
        # strict JSON: json.dumps would emit bare Infinity/NaN tokens
        # that non-Python parsers reject — a bound that never landed
        # serializes as null (the generic_cylinders _finite convention)
        import math
        return v if math.isfinite(v) else None
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:  # numpy scalars and arrays, torch tensors
        import numpy as np
        if isinstance(v, np.ndarray):
            return _jsonable(v.tolist())
        if isinstance(v, np.generic):
            return _jsonable(v.item())
        if hasattr(v, "tolist"):  # torch.Tensor
            return _jsonable(v.tolist())
    except Exception:
        pass
    return repr(v)


@dataclasses.dataclass(frozen=True)
class Event:
    """One telemetry record.  `data` holds the kind-specific payload."""

    kind: str
    seq: int                 # per-bus monotone sequence number
    t_wall: float            # time.time()
    t_mono: float            # time.perf_counter()
    run: str = ""            # run id (new_run_id())
    cyl: str = ""            # producing cylinder ("hub", "spoke0:...", ...)
    hub_iter: int | None = None
    level: int | None = None  # console verbosity level (CONSOLE only)
    # causal trace context (telemetry/tracecontext.py) —
    # empty on pre-trace rows, stamped by the bus otherwise
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    data: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "seq": self.seq,
             "t_wall": self.t_wall, "t_mono": self.t_mono,
             "run": self.run, "cyl": self.cyl}
        if self.hub_iter is not None:
            d["iter"] = self.hub_iter
        if self.level is not None:
            d["level"] = self.level
        if self.trace_id:
            d["trace_id"] = self.trace_id
            d["span_id"] = self.span_id
            if self.parent_span_id:
                d["parent_span_id"] = self.parent_span_id
        d["data"] = _jsonable(self.data)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


def make_event(kind: str, seq: int, *, run: str = "", cyl: str = "",
               hub_iter: int | None = None, level: int | None = None,
               trace=None, data: dict | None = None) -> Event:
    """`trace` is a TraceContext (or any object carrying
    trace_id/span_id/parent_span_id) — None leaves the row unstamped."""
    return Event(kind=kind, seq=seq, t_wall=time.time(),
                 t_mono=time.perf_counter(), run=run, cyl=cyl,
                 hub_iter=hub_iter, level=level,
                 trace_id=getattr(trace, "trace_id", "") or "",
                 span_id=getattr(trace, "span_id", "") or "",
                 parent_span_id=getattr(trace, "parent_span_id", "") or "",
                 data=data or {})
