###############################################################################
# MPC streams on the wheel server (port of mpisppy_tpu/mpc/stream.py;
# docs/mpc.md, docs/serving.md streaming lifecycle).
#
# An MPC session (SubmitRequest.mpc_steps > 0) is one LONG-LIVED
# latency-class session: the serve engine routes it here instead of the
# one-wheel solve, and the stream emits one `step` protocol line per
# solved window over the existing JSON-lines connection.  The pieces:
#
#   per-step accounting   every completed window calls
#                         Session.note_step, which re-arms the per-step
#                         deadline (the streaming reaper's
#                         consecutive-miss budget, serve/server.py) and
#                         charges the step through WFQ
#                         (admission.charge_step) — a stream pays per
#                         window, so it can never starve throughput
#                         tenants;
#   preemption survival   after every window the stream checkpoint
#                         (next step index + the SHIFTED warm plane —
#                         the base key is derived from {model args,
#                         step}, so it rides in the argv) is written
#                         atomically to the session spool.  A preempted
#                         stream returns the engine's standard
#                         ('preempted', ...) verdict, re-enters the
#                         queue front, and the resumed worker re-solves
#                         the SAME window from the SAME plane —
#                         bit-identical resampling (horizon.py), so the
#                         resumed stream reproduces the fault-free
#                         stream's per-step bounds exactly.  The .npz
#                         layout (next_step, W, xbar_nodes, x) is the
#                         JAX package's: either package resumes the
#                         other's stream;
#   telemetry             mpc-step / mpc-degraded events on the
#                         session's scoped bus (-> session-<sid>.jsonl
#                         -> telemetry watch's per-stream step-latency
#                         row) + mpc_* metrics.
###############################################################################
from __future__ import annotations

import os
import time

import numpy as np

from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.resilience.faults import PreemptionError
from mpisppy_tpu_torch.telemetry import metrics as _metrics


def _load_checkpoint(path: str | None):
    """(next_step, plane) from the stream checkpoint, or (0, None)."""
    if not path or not os.path.exists(path):
        return 0, None
    try:
        with np.load(path) as z:
            return int(z["next_step"]), {
                "W": np.asarray(z["W"]),
                "xbar_nodes": np.asarray(z["xbar_nodes"]),
                "x": np.asarray(z["x"]),
            }
    except Exception:
        # an unreadable/torn checkpoint restarts the stream cold — the
        # window data is still bit-identical (pure in {argv, step})
        return 0, None


def _save_checkpoint(path: str | None, next_step: int, plane: dict):
    """Atomic replace, the hub checkpoint convention — a preemption
    mid-write leaves the previous step's file intact."""
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, next_step=np.int64(next_step), W=plane["W"],
                 xbar_nodes=plane["xbar_nodes"], x=plane["x"])
    os.replace(tmp, path)


def run_stream(session, fault_plan=None, device: str = "cuda") -> tuple:
    """Run one MPC session to completion (or preemption), every window
    on `device` (the serving engine's).  Same verdict surface as
    WheelEngine.run: ('done', payload) or ('preempted', payload); raises
    on a failed build (the server types it for the client)."""
    from mpisppy_tpu_torch.mpc.driver import RollingDriver
    from mpisppy_tpu_torch.mpc.horizon import horizon_for

    if fault_plan is not None:
        fault_plan.serve_before_solve(session.tenant, session.ordinal)
    spec = session.spec
    horizon = horizon_for(spec)
    hub_options = {
        "run_id": session.run_id,
        "telemetry_bus": session.bus,
        "preempt_event": session.preempt_event,
    }
    if fault_plan is not None:
        hub_options["fault_plan"] = fault_plan
    driver = RollingDriver(horizon, hub_options=hub_options,
                           device=device)

    start, plane = 0, None
    if session.restore:
        start, plane = _load_checkpoint(session.checkpoint_path)
        if plane is None:
            # no (readable) spool: restart from the session's own
            # cursor, cold — deterministic data, but the warm plane is
            # gone, so only the spool path preserves per-step bounds
            start = int(session.mpc_step)
        session.mpc_step = start
        _metrics.REGISTRY.inc("mpc_stream_resumes_total")
    else:
        _metrics.REGISTRY.inc("mpc_streams_total")
    session.reset_step_anchor()

    latencies, degraded_steps, warm_steps, cold_fallbacks = [], 0, 0, 0
    last = None
    # per-window spans parent under the session's current segment
    # (one child span per MPC step)
    seg = getattr(session, "segment", None) \
        or getattr(session, "trace", None)
    for k in range(start, int(spec.mpc_steps)):
        step_span = seg.child() if seg is not None else None
        if step_span is not None:
            # the window's whole event stream (hub iterations, spans,
            # dispatch joins) rides the step span; the segment scope is
            # restored below — or by end_segment on a preemption
            session.bus.set_trace(step_span)
        session.bus.emit(
            tel.SPAN_START, run=session.run_id, cyl="mpc",
            trace=step_span, name="mpc-step", session=session.sid,
            step=k)
        t0 = time.perf_counter()
        try:
            res = driver.run_step(k, warm_plane=plane)
        except PreemptionError as e:
            # the stream checkpoint from step k-1 is the resume point:
            # the re-admitted worker re-solves window k from the same
            # shifted plane, bit-identically
            return "preempted", {"step": k, "detail": str(e)}
        latency = time.perf_counter() - t0
        plane = driver.next_plane(res)
        _save_checkpoint(session.checkpoint_path, k + 1, plane)
        session.note_step(k, rel_gap=res.rel_gap)
        latencies.append(latency)
        warm_steps += 1 if res.warm else 0
        cold_fallbacks += 1 if res.cold_fallback else 0
        degraded_steps += 1 if res.degraded else 0
        last = res
        session.bus.emit(
            tel.MPC_STEP, run=session.run_id, cyl="mpc",
            trace=step_span,
            session=session.sid, tenant=session.tenant, step=k,
            outer=res.outer, inner=res.inner, rel_gap=res.rel_gap,
            iterations=res.iterations, warm=res.warm,
            cold_fallback=res.cold_fallback, degraded=res.degraded,
            latency_s=latency)
        if res.degraded:
            session.bus.emit(
                tel.MPC_DEGRADED, run=session.run_id, cyl="mpc",
                trace=step_span,
                session=session.sid, step=k, rel_gap=res.rel_gap,
                gap_target=horizon.gap_target)
            _metrics.REGISTRY.inc("mpc_degraded_steps_total")
        _metrics.REGISTRY.inc("mpc_steps_total")
        if res.warm:
            _metrics.REGISTRY.inc("mpc_warm_steps_total")
        if res.cold_fallback:
            _metrics.REGISTRY.inc("mpc_cold_fallbacks_total")
        _metrics.REGISTRY.set_gauge("mpc_step_latency_s", latency)
        _metrics.REGISTRY.observe("mpc_step_latency_hist_s", latency)
        session.send({
            "event": "step", "session": session.sid, "step": k,
            "outer": res.outer, "inner": res.inner,
            "rel_gap": res.rel_gap, "warm": res.warm,
            "degraded": res.degraded, "latency_s": round(latency, 4),
            "x_root": [round(float(v), 6) for v in res.x_root]})
    if seg is not None:
        session.bus.set_trace(seg)   # leave the last step's span
    if session.checkpoint_path:
        try:
            os.remove(session.checkpoint_path)
        except OSError:
            pass
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    return "done", {
        "steps": int(spec.mpc_steps),
        "warm_steps": warm_steps,
        "cold_fallbacks": cold_fallbacks,
        "degraded_steps": degraded_steps,
        "rel_gap": None if last is None else float(last.rel_gap),
        "outer": None if last is None else float(last.outer),
        "inner": None if last is None else float(last.inner),
        "step_latency_p50_s": round(float(np.percentile(lat, 50)), 4),
        "step_latency_p99_s": round(float(np.percentile(lat, 99)), 4),
        "preemptions": session.preemptions,
    }
