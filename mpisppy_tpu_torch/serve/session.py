###############################################################################
# Session lifecycle (port of mpisppy_tpu/serve/session.py;
# docs/serving.md).
#
# One Session is one tenant problem instance moving through
#
#     QUEUED -> ADMITTED -> RUNNING -> DONE | FAILED
#                              ^  \
#                              |   v
#                           DEGRADED        (preemption-restore /
#                                            watchdog degrade; resumes
#                                            to RUNNING)
#     QUEUED -> REJECTED                    (admission backpressure)
#
# Transitions are validated against TRANSITIONS (an illegal move is a
# server bug and raises), and every transition is emitted as ONE
# `session-state` event on BOTH buses: the session's own scoped bus
# (below) and the server bus, so `telemetry watch --trace-dir` and the
# analyzer see the same lifecycle the client streamed.
#
# PER-SESSION TELEMETRY SCOPING: each session owns an EventBus with a
# JsonlSink writing trace_dir/session-<sid>.jsonl.  The session's hub
# gets THIS bus as options['telemetry_bus'], so the whole existing
# event taxonomy (hub-iteration / bound-accept / checkpoint-* /
# run-end, docs/telemetry.md) lands per session with no new plumbing —
# and a _ClientForwardSink subscriber converts the bound-progress
# stream into the client's `progress` lines.  One wheel vocabulary,
# three consumers (client stream, per-session trace, live watch).
###############################################################################
from __future__ import annotations

import itertools
import os
import threading
import time

from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.serve.protocol import SubmitRequest
from mpisppy_tpu_torch.telemetry import metrics as _metrics

QUEUED = "QUEUED"
ADMITTED = "ADMITTED"
RUNNING = "RUNNING"
DEGRADED = "DEGRADED"
DONE = "DONE"
FAILED = "FAILED"
REJECTED = "REJECTED"

#: legal lifecycle moves (docs/serving.md session-state table)
TRANSITIONS = {
    QUEUED: (ADMITTED, REJECTED, FAILED),
    ADMITTED: (RUNNING, FAILED),
    RUNNING: (DEGRADED, DONE, FAILED),
    DEGRADED: (RUNNING, DONE, FAILED),
    DONE: (),
    FAILED: (),
    REJECTED: (),
}

TERMINAL_STATES = (DONE, FAILED, REJECTED)

_sid_counter = itertools.count()


class _ClientForwardSink:
    """Bus subscriber forwarding the session's bound progress and
    terminal verdicts to its client as protocol lines.  Send failures
    (a disconnected client) detach the outbox — the session keeps
    running to its terminal state regardless (quota accounting and the
    per-session trace never depend on the client still listening)."""

    def __init__(self, session: "Session"):
        self.session = session

    def handle(self, event) -> None:
        kind = event.kind
        if kind == tel.HUB_ITERATION:
            d = event.data
            self.session.send({
                "event": "progress", "session": self.session.sid,
                "iter": d.get("iter"), "outer": d.get("outer"),
                "inner": d.get("inner"), "rel_gap": d.get("rel_gap")})
        elif kind == tel.CHECKPOINT_RESTORE:
            self.session.send({
                "event": "restored", "session": self.session.sid,
                "iter": event.hub_iter})

    def close(self) -> None:
        pass


class Session:
    """One tenant problem instance: the admission unit, the telemetry
    scope, and the terminal-outcome obligation."""

    def __init__(self, spec: SubmitRequest, outbox=None,
                 server_bus=None, trace_dir: str | None = None):
        self.sid = f"s{next(_sid_counter):04d}"
        self.spec = spec
        self.tenant = spec.tenant
        self.sla = spec.sla
        self.ordinal = -1          # per-tenant admission ordinal
                                   # (stamped by the admission queue)
        self.run_id = tel.new_run_id()   # the wheel run this session IS
        self.server_bus = server_bus
        self.t_submit = time.perf_counter()
        self.t_started: float | None = None
        self.t_finished: float | None = None
        self.deadline = None if spec.deadline_s is None \
            else self.t_submit + float(spec.deadline_s)
        self.restore = False       # resume from checkpoint (preemption)
        self.preemptions = 0
        self.checkpoint_path: str | None = None
        # -- fleet surface -- a session routed through the
        # fleet router carries its placement identity with it: which
        # replica currently runs it, its content-addressed routing key,
        # and how many times it migrated.  preempt_event is the live-
        # migration drain signal: the hub checks it at every sync
        # prologue and raises PreemptionError (emergency checkpoint)
        # when set, so a drain lands at a consistent boundary.
        self.replica = ""
        self.structure_key = ""
        self.migrations = 0
        self.resume_iter = 0       # engine-agnostic resume cursor
        self.preempt_event = threading.Event()
        # invoked (with this session) after settle() delivers the one
        # terminal outcome — the fleet router's quota-release hook
        self.on_terminal = None
        # -- rolling-horizon stream surface -- an MPC
        # session (spec.mpc_steps > 0) is long-lived by design: its
        # liveness unit is the STEP, not the session.  mpc_step is the
        # resume cursor (next window to solve — a preempted stream
        # restores here and re-derives the window bit-identically);
        # note_step advances it, re-arms the per-step deadline anchor,
        # and fires on_step (the admission queue's per-step WFQ charge,
        # server.submit_session wires it).
        self.mpc_step = 0
        self.on_step = None
        self._step_anchor = self.t_submit    # guarded-by: _lock
        self._trace_sink = None    # guarded-by: _lock
        # Lock discipline: lifecycle
        # state and the client outbox are touched from the reader
        # thread, the scheduler thread, the session worker, and the
        # deadline reaper.
        self._lock = threading.Lock()
        self._state = QUEUED              # guarded-by: _lock
        self._outbox = outbox             # guarded-by: _lock
        self._terminal_sent = False       # guarded-by: _lock
        self.outcome: dict | None = None  # guarded-by: _lock
        # per-session telemetry scope
        self.bus = tel.EventBus()
        self.trace_path = None
        # causal trace (telemetry/tracecontext.py): adopt the
        # client's traceparent or mint a fresh root — either way every
        # event this session (and its hub, dispatch attribution, MPC
        # windows) emits carries one trace id end to end.  The root
        # span IS the request; each run attempt opens a child segment
        # span (begin_segment), so a migration renders as two sibling
        # segments under one root and the gap between them is the
        # migration gap.
        self.trace = tel.TraceContext.from_traceparent(
            getattr(spec, "traceparent", None)) or tel.TraceContext.mint()
        self.segment = None        # current run-segment TraceContext
        self.bus.set_trace(self.trace)
        if trace_dir:
            self.attach_trace(trace_dir)
        self.bus.subscribe(_ClientForwardSink(self))
        # dual-emit like transition(): in the fleet path the session
        # bus has no sinks until the replica attaches its trace dir,
        # so the root span-start must also land on the server/router
        # stream or the assembled tree loses its root's name
        for bus in (self.bus, self.server_bus):
            if bus is not None:
                bus.emit(tel.SPAN_START, run=self.run_id, cyl="serve",
                         trace=self.trace, name="request",
                         session=self.sid, tenant=self.tenant,
                         sla=self.sla)

    # -- per-replica trace attachment --------------------------
    def attach_trace(self, trace_dir: str) -> None:
        """Subscribe a JsonlSink under trace_dir for this session.  A
        migrating session detaches from the source replica's trace dir
        and re-attaches under the destination's, so each replica's
        trace shows exactly the lifecycle segment it hosted (watch
        joins the segments on sid + run id)."""
        self.detach_trace()
        sink = tel.JsonlSink(os.path.join(
            trace_dir, f"session-{self.sid}.jsonl"))
        with self._lock:
            self._trace_sink = sink
            self.trace_path = sink.path
        self.bus.subscribe(sink)

    def detach_trace(self) -> None:
        with self._lock:
            sink = self._trace_sink
            self._trace_sink = None
        if sink is not None:
            self.bus.unsubscribe(sink)
            sink.close()

    @property
    def trace_attached(self) -> bool:
        with self._lock:
            return self._trace_sink is not None

    # -- run segments ------------------------------------------
    def begin_segment(self, name: str = "segment", **data):
        """Open a child span of the request trace for ONE run attempt
        (one replica hosting, one resume).  The session bus is scoped
        to it, so every hub/dispatch/MPC event of the attempt carries
        the segment span; a later attempt (after preemption/migration)
        opens a sibling segment under the same root."""
        seg = self.trace.child()
        self.segment = seg
        self.bus.set_trace(seg)
        self.bus.emit(tel.SPAN_START, run=self.run_id, cyl="serve",
                      name=name, session=self.sid,
                      replica=self.replica or None,
                      resume_iter=self.resume_iter,
                      restore=self.restore, **data)
        return seg

    def end_segment(self) -> None:
        """Detach the current segment span (preemption/migration
        hand-off): subsequent events fall back to the request root
        until the next begin_segment."""
        self.segment = None
        self.bus.set_trace(self.trace)

    # -- state machine ----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def transition(self, new_state: str, **data) -> None:
        """One validated lifecycle move + its session-state event on
        both buses + the client's session-state line."""
        with self._lock:
            old = self._state
            if new_state not in TRANSITIONS[old]:
                raise RuntimeError(
                    f"illegal session transition {old} -> {new_state} "
                    f"({self.sid})")
            self._state = new_state
        payload = dict(data)
        payload.update(session=self.sid, tenant=self.tenant,
                       sla=self.sla, state=new_state, prev=old)
        if self.replica:
            payload.setdefault("replica", self.replica)
        trace = self.segment or self.trace
        for bus in (self.bus, self.server_bus):
            if bus is not None:
                bus.emit(tel.SESSION_STATE, run=self.run_id,
                         cyl="serve", trace=trace, **payload)
        self.send({"event": "session-state", **payload})

    def is_terminal(self) -> bool:
        with self._lock:
            return self._state in TERMINAL_STATES

    # -- client stream ----------------------------------------------------
    def send(self, msg: dict) -> bool:
        """Best-effort line to this session's client; a dead outbox is
        detached (the session is then 'detached' but still accounted)."""
        with self._lock:
            outbox = self._outbox
        if outbox is None:
            return False
        try:
            outbox(msg)
            return True
        except Exception:
            with self._lock:
                self._outbox = None
            _metrics.REGISTRY.inc("serve_disconnects_total")
            return False

    def detach(self) -> None:
        """Drop the client outbox (disconnect seam / closed reader)."""
        with self._lock:
            self._outbox = None

    @property
    def detached(self) -> bool:
        with self._lock:
            return self._outbox is None

    # -- terminal outcomes ------------------------------------------------
    def settle(self, event: str, **payload) -> bool:
        """Deliver the session's ONE terminal outcome: transition to
        the terminal state, record the outcome, send the terminal
        protocol line exactly once, and close the session bus.  The
        no-hang contract's last line of defense — every exit path of
        the server worker funnels through here.  Returns True when
        THIS call performed the delivery (False = already settled), so
        callers can account failures exactly once."""
        state = {"done": DONE, "failed": FAILED,
                 "rejected": REJECTED}[event]
        with self._lock:
            already = self._terminal_sent
            if not already:
                self._terminal_sent = True
                self.outcome = {"event": event, **payload}
        if already:
            return False
        self.t_finished = time.perf_counter()
        if self.state != state:       # REJECTED may come straight from
            self.transition(state, **payload)   # QUEUED; others move
        self.send({"event": event, "session": self.sid, **payload})
        # one terminal SLO sample per session (slo.py folds
        # these into error budgets) — stamped on the request ROOT span,
        # emitted before the bus closes so the per-session trace ends
        # on it
        total_s = self.t_finished - self.t_submit
        obs = dict(session=self.sid, tenant=self.tenant, sla=self.sla,
                   outcome=event, total_s=round(total_s, 6),
                   deadline_s=self.spec.deadline_s,
                   migrations=self.migrations,
                   preemptions=self.preemptions)
        if self.streaming:
            obs.update(steps=self.mpc_step,
                       steps_expected=self.spec.mpc_steps,
                       step_deadline_s=self.spec.step_deadline_s)
        for bus in (self.bus, self.server_bus):
            if bus is not None:
                bus.emit(tel.SLO_OBSERVATION, run=self.run_id,
                         cyl="serve", trace=self.trace, **obs)
        _metrics.REGISTRY.observe("slo_session_latency_s", total_s,
                                  sla=self.sla)
        self.bus.close()
        cb = self.on_terminal
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass   # a router hook must never block the delivery
        return True

    # -- rolling-horizon stream --------------------------------
    @property
    def streaming(self) -> bool:
        """True for an MPC stream session (one solution line per step;
        reaped on per-step deadline misses, not session wall clock)."""
        return getattr(self.spec, "mpc_steps", 0) > 0

    def reset_step_anchor(self) -> None:
        """Re-arm the per-step deadline clock — called when the stream
        (re)enters RUNNING so queue/preemption time is never billed
        against the first step's deadline."""
        with self._lock:
            self._step_anchor = time.perf_counter()

    def note_step(self, step: int, **info) -> None:
        """One completed window: advance the resume cursor, re-arm the
        step deadline, charge the step through WFQ (on_step)."""
        with self._lock:
            self.mpc_step = int(step) + 1
            self._step_anchor = time.perf_counter()
        cb = self.on_step
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass   # accounting must never kill the stream

    def steps_overdue(self, now: float | None = None) -> int:
        """Whole per-step deadline windows elapsed since the last
        completed step — the reaper's consecutive-miss count.  0 when
        the session has no per-step deadline."""
        sd = getattr(self.spec, "step_deadline_s", None)
        if not sd:
            return 0
        if now is None:
            now = time.perf_counter()
        with self._lock:
            anchor = self._step_anchor
        return max(0, int((now - anchor) / float(sd)))

    def seconds(self) -> float | None:
        if self.t_finished is None:
            return None
        return self.t_finished - self.t_submit
