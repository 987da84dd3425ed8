###############################################################################
# mpisppy_tpu_torch.telemetry — the wheel's observability spine (port of
# the host modules of mpisppy_tpu/telemetry).
#
#   events    — typed event taxonomy (hub iteration, harvest, bound
#               accept/reject/strike, fault, plane write, ...)
#   bus       — EventBus: thread-safe, failure-isolated fan-out
#   sinks     — JsonlSink / ConsoleSink / MetricsSnapshotSink
#   views     — the Hub.trace / Spoke.trace list views
#   metrics   — MetricsRegistry + the shared snapshot schema
#   console   — log(): what global_toc routes through
#   profiler  — torch.profiler record_function spans and the
#               --profile-dir session (ProfilerSession)
#   flightrec — the always-on crash black box (last ~512 events,
#               dumped to flight-<runid>.jsonl when the wheel dies)
#   counters  — per-lane PDHG kernel counters (--kernel-counters), the
#               state-borne totals the hub harvests once per sync
#   deviceprof, roofline — read a ProfilerSession capture (kineto's
#               chrome trace) into a device timeline and its H100
#               roofline report (device_profile.json)
#   analyze, spans, slo, watch, regress — the trace toolbox, run as
#               `python -m mpisppy_tpu_torch.telemetry` (analyze, watch,
#               trace, slo, compare, gate)
#
# The event schema is the JAX package's byte for byte (kinds, field
# names, JSONL line layout), so either package's analyzer reads the
# other's traces.
#
# Its modules (minus profiler and counters) import only the stdlib, so
# the toolbox needs no card and no JAX (the port's own __init__ loads
# torch).
###############################################################################
from __future__ import annotations

from mpisppy_tpu_torch.telemetry import console, metrics
from mpisppy_tpu_torch.telemetry.bus import EventBus
from mpisppy_tpu_torch.telemetry.events import (  # noqa: F401 (re-exports)
    ADMISSION_REJECTED, BOUND_ACCEPT, BOUND_EVICT, BOUND_REJECT,
    CHECKPOINT_RESTORE, CHECKPOINT_WRITE, CONSOLE, DISPATCH,
    DISPATCH_QUARANTINE, DISPATCH_RETRY, EXCHANGE_OVERLAP,
    FAULT_INJECTED, FLEET_PLACEMENT, HUB_ITERATION, KERNEL_COUNTERS,
    LANE_QUARANTINE, MESH_HOST_LOST, MESH_RESHARD, MESH_STATE,
    MESH_STRAGGLER, MPC_DEGRADED, MPC_STEP, PLANE_WRITE, PROFILE,
    REPLICA_STATE, RUN_END,
    RUN_START, SESSION_MIGRATED, SESSION_STATE, SLO_OBSERVATION, SPAN,
    SPAN_START, SPOKE_DISABLE, SPOKE_HARVEST, SPOKE_STRIKE, WATCHDOG,
    Event, new_run_id,
)
from mpisppy_tpu_torch.telemetry.flightrec import FlightRecorder  # noqa: F401
from mpisppy_tpu_torch.telemetry.tracecontext import TraceContext  # noqa: F401
from mpisppy_tpu_torch.telemetry.sinks import (  # noqa: F401
    ConsoleSink, JsonlSink, MetricsSnapshotSink, Sink,
)
from mpisppy_tpu_torch.telemetry.views import WheelTraceView  # noqa: F401


def from_cfg(cfg, registry=None):
    """Build the run's EventBus from the telemetry_args Config group
    (utils/config.py).  Returns None when no telemetry output is
    requested — callers then skip all wiring.  Always applies
    --telemetry-verbosity to the console."""
    verbosity = int(cfg.get("telemetry_verbosity", console.INFO))
    console.set_verbosity(verbosity)
    trace_path = cfg.get("trace_jsonl")
    snap_path = cfg.get("metrics_snapshot")
    if not trace_path and not snap_path:
        return None
    bus = EventBus()
    if trace_path:
        bus.subscribe(JsonlSink(trace_path))
    if snap_path:
        bus.subscribe(MetricsSnapshotSink(
            snap_path, registry=registry,
            every_s=float(cfg.get("metrics_every_s", 30.0))))
    # the human stream moves onto the bus so the console and the JSONL
    # trace can never diverge (console.log suppresses its direct print
    # while a ConsoleSink-bearing bus is attached)
    bus.subscribe(ConsoleSink(verbosity))
    console.attach(bus)
    return bus


def close_bus(bus) -> None:
    """Flush + detach a from_cfg bus (final metrics snapshot, JSONL
    close).  Safe on None."""
    if bus is None:
        return
    console.detach(bus)
    bus.close()
