###############################################################################
# The multi-tenant wheel server (port of mpisppy_tpu/serve/server.py;
# docs/serving.md).
#
# A long-lived process multiplexing many concurrent problem instances
# — different tenants, different models — through one shared device
# wheel stack: `python -m mpisppy_tpu_torch.serve --unix /tmp/wheel.sock`.
#
# Sessions run in worker threads of this process.  Every thread launches
# on the CUDA device's default stream, so the card runs one session's
# window at a time while the threads overlap their host work: one device
# stream advances several tenants between host exchanges.
#
# Thread anatomy (every shared field lock-annotated):
#
#   acceptor ── one reader thread per client connection (parses JSON
#   lines, answers acks, routes submits into admission)
#   scheduler ── pops the FairQueue into session worker threads while
#   capacity (max_running) is free; doubles as the DEADLINE REAPER: a
#   session past its deadline gets a typed SolveFailed-style terminal
#   `failed` (reason deadline) and its quota back, the abandoned
#   worker drains in the background (the dispatch-timeout contract one
#   layer up)
#   worker ── runs the session engine; every exit path funnels into
#   Session.settle: done / failed(typed) / rejected — a client ALWAYS
#   observes a terminal outcome, never a hang.  A preempted session
#   (emergency checkpoint already on disk) re-enters the queue FRONT
#   with restore=True and resumes without client-visible state loss.
#
# Sessions sharing QP structure coalesce their oracle dispatches into
# shared megabatches through the process dispatch scheduler (structure
# interning, serve/multiplex.py), and with multiplexing on each wheel
# runs the async hub under the server's ExchangeRing — one
# device stream advances several tenants between host exchanges.
###############################################################################
from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time

from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.serve import admission as adm
from mpisppy_tpu_torch.serve import multiplex, protocol
from mpisppy_tpu_torch.serve import session as sess_mod
from mpisppy_tpu_torch.telemetry import metrics as _metrics


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Server knobs (CLI: python -m mpisppy_tpu_torch.serve --help)."""

    unix_path: str | None = None     # unix socket path (preferred)
    host: str = "127.0.0.1"          # TCP fallback
    port: int = 0                    # 0 = ephemeral
    max_running: int = 2             # concurrent session workers
    max_queued: int = 64             # global queue cap (backpressure)
    max_queued_per_tenant: int = 32
    tenant_quota: int = 2            # per-tenant in-flight cap
    tenant_weights: dict | None = None
    latency_burst: int = 4           # SLA starvation guard
    trace_dir: str | None = None     # per-session JSONL traces
    spool_dir: str | None = None     # session checkpoints
    multiplex: bool = True           # async hub + exchange ring
    default_deadline_s: float | None = None
    step_miss_budget: int = 3        # consecutive per-step deadline
                                     # misses before a RUNNING MPC
                                     # stream is reaped
    engine: object | None = None     # injectable (tests/chaos)
    fault_plan: object | None = None  # chaos seams (ServeFault et al.)
    bus: object | None = None        # server-level telemetry bus
    replica_id: str = ""             # fleet replica identity
                                     # (stamped on every session served)
    device: str = "cuda"             # where every session's wheel runs
                                     # (appended to the session argv
                                     # after the client's args, so a
                                     # client cannot move it)


class WheelServer:
    """See the module header."""

    def __init__(self, options: ServeOptions = ServeOptions()):
        self.options = options
        self.bus = options.bus or tel.EventBus()
        self.queue = adm.FairQueue(
            max_queued=options.max_queued,
            max_queued_per_tenant=options.max_queued_per_tenant,
            default_quota=options.tenant_quota,
            weights=options.tenant_weights,
            latency_burst=options.latency_burst)
        self.ring = multiplex.ExchangeRing() if options.multiplex \
            else None
        if options.engine is not None:
            self.engine = options.engine
        else:
            from mpisppy_tpu_torch.serve.engine import WheelEngine
            self.engine = WheelEngine(multiplexed=options.multiplex,
                                      device=options.device)
        for d in (options.trace_dir, options.spool_dir):
            if d:
                os.makedirs(d, exist_ok=True)
        self._sock: socket.socket | None = None
        self.address = None           # bound address after start()
        # Lock discipline: the
        # session registry and lifecycle counters are shared by the
        # acceptor, reader, scheduler and worker threads.
        self._lock = threading.Lock()
        self._sessions: dict = {}         # guarded-by: _lock (live +
                                          # a bounded terminal tail —
                                          # see _prune_sessions)
        self._slots: set = set()          # guarded-by: _lock (sids
                                          # currently holding a worker
                                          # slot — one release per
                                          # admission, re-admittable)
        self._running = 0                 # guarded-by: _lock
        self._stopping = False            # guarded-by: _lock
        self._threads: list = []          # guarded-by: _lock
        self._submitted = 0               # guarded-by: _lock
        self._preemptions = 0             # guarded-by: _lock
        self._state_totals: dict = {}     # guarded-by: _lock (terminal
                                          # counts of PRUNED sessions)
        self._wake = threading.Condition(self._lock)
        #: terminal sessions kept for inspection before pruning — the
        #: registry must stay bounded in a long-lived server
        self.keep_terminal = 256

    # -- lifecycle --------------------------------------------------------
    def start(self):
        opts = self.options
        if opts.unix_path:
            try:
                os.unlink(opts.unix_path)
            except OSError:
                pass
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(opts.unix_path)
            self.address = opts.unix_path
        else:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((opts.host, opts.port))
            self.address = s.getsockname()
        s.listen(64)
        s.settimeout(0.25)
        self._sock = s
        for name, target in (("serve-accept", self._accept_loop),
                             ("serve-sched", self._schedule_loop)):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._note_thread(t)
        tel.console.log(f"serve: listening on {self.address} "
                        f"(max_running={opts.max_running}, "
                        f"multiplex={opts.multiplex})")
        return self

    def stop(self, timeout: float = 10.0):
        """Drain: stop admitting (queued sessions get a typed
        rejection), wait for running sessions up to `timeout`, close."""
        with self._lock:
            self._stopping = True
            self._wake.notify_all()
        for s in self.queue.drain():
            self._reject(s, "draining")
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                if self._running == 0:
                    break
            time.sleep(0.05)
        # second drain: a worker that observed a preemption WHILE the
        # first drain ran may have requeued its session concurrently —
        # it must still get its typed terminal outcome, never a hang
        for s in self.queue.drain():
            self._reject(s, "draining")
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self.options.unix_path:
            try:
                os.unlink(self.options.unix_path)
            except OSError:
                pass
        if self.options.bus is None:
            self.bus.close()

    def _reject(self, session, reason: str, detail: str = ""):
        """Typed terminal outcome for a queued session leaving the
        queue unserved (drain path).  Idempotent: a session that
        already settled (deadline-reaped while queued) is left alone.
        A DEGRADED session caught here (preempted during drain) fails
        typed instead — REJECTED is a from-QUEUED verdict."""
        if session.is_terminal():
            return
        if session.state == sess_mod.DEGRADED:
            session.settle("failed", reason=reason,
                           detail=detail or "preempted while the "
                           "server drained; checkpoint retained")
            return
        self.bus.emit(tel.ADMISSION_REJECTED, run=session.run_id,
                      cyl="serve", tenant=session.tenant,
                      reason=reason, detail=detail)
        _metrics.REGISTRY.inc("serve_admission_rejects_total")
        session.settle("rejected", reason=reason, detail=detail)

    def serve_forever(self):
        """Block until interrupted (the __main__ entry point)."""
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            self.stop()

    # -- client plumbing --------------------------------------------------
    def _accept_loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._client_loop,
                                 args=(conn,), daemon=True,
                                 name="serve-client")
            t.start()
            self._note_thread(t)

    def _client_loop(self, conn: socket.socket):
        """One client's reader: parse lines, ack, route.  The outbox
        closure serializes writes per connection."""
        wlock = threading.Lock()
        my_sessions: list = []

        def outbox(msg: dict):
            data = protocol.encode(msg)
            with wlock:
                conn.sendall(data)

        try:
            rfile = conn.makefile("rb")
            for msg in protocol.iter_lines(rfile):
                if "_malformed" in msg:
                    self._safe_send(outbox, {
                        "ok": False, "error": "malformed-json",
                        "detail": msg["_malformed"][:200]})
                    continue
                op = msg.get("op")
                if op == "ping":
                    self._safe_send(outbox, {"ok": True, "op": "ping"})
                elif op == "stats":
                    self._safe_send(outbox, {"ok": True, "op": "stats",
                                             "stats": self.stats()})
                elif op == "status":
                    self._safe_send(outbox, {
                        "ok": True, "op": "status",
                        "status": self.status()})
                elif op == "submit":
                    try:
                        self._handle_submit(msg, outbox, my_sessions)
                    except Exception as e:  # noqa: BLE001 — typed ack:
                        # one bad submit must never kill the reader
                        # (every later submit on the connection would
                        # hang unanswered)
                        self._safe_send(outbox, {
                            "ok": False, "error": "internal",
                            "detail": f"{type(e).__name__}: "
                                      f"{e}"[:300]})
                else:
                    self._safe_send(outbox, {
                        "ok": False, "error": "unknown-op",
                        "op": op})
        except (OSError, ValueError):
            pass
        finally:
            for s in my_sessions:
                s.detach()
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _safe_send(outbox, msg: dict) -> bool:
        try:
            outbox(msg)
            return True
        except Exception:
            return False

    def _handle_submit(self, msg: dict, outbox, my_sessions: list):
        try:
            spec = protocol.SubmitRequest.from_dict(msg)
        except protocol.ProtocolError as e:
            self._safe_send(outbox, {"ok": False,
                                     "error": "bad-request",
                                     "detail": str(e)})
            return
        if spec.deadline_s is None \
                and self.options.default_deadline_s is not None:
            spec = dataclasses.replace(
                spec, deadline_s=self.options.default_deadline_s)
        session = sess_mod.Session(
            spec, outbox=outbox, server_bus=self.bus,
            trace_dir=self.options.trace_dir)
        try:
            self.submit_session(session)
        except adm.AdmissionRejected as e:
            # typed backpressure — the terminal outcome arrives in the
            # SAME ack so a flooding client can never mistake a reject
            # for a hang
            self.bus.emit(tel.ADMISSION_REJECTED, run=session.run_id,
                          cyl="serve", tenant=spec.tenant,
                          trace=session.trace,
                          reason=e.reason, detail=e.detail)
            _metrics.REGISTRY.inc("serve_admission_rejects_total")
            session.settle("rejected", reason=e.reason, detail=e.detail)
            self._safe_send(outbox, {"ok": False, "session": session.sid,
                                     "error": "rejected",
                                     "reason": e.reason})
            return
        my_sessions.append(session)
        self._safe_send(outbox, {"ok": True, "session": session.sid,
                                 "tenant": spec.tenant})

    def submit_session(self, session) -> None:
        """Admit an externally-constructed session — the socket submit
        path above and the fleet router's replica-assignment path
        share it.  Stamps the replica identity, attaches the
        per-replica trace and checkpoint spool, and enters admission.
        Raises adm.AdmissionRejected on backpressure WITHOUT settling
        the session: the caller owns the typed terminal outcome (the
        router re-places a migrating session instead of rejecting)."""
        if self.options.replica_id:
            session.replica = self.options.replica_id
        if self.options.trace_dir and not session.trace_attached:
            session.attach_trace(self.options.trace_dir)
        if session.checkpoint_path is None and self.options.spool_dir:
            session.checkpoint_path = os.path.join(
                self.options.spool_dir, f"ckpt-{session.sid}.npz")
        if session.streaming and session.on_step is None:
            # per-step WFQ charge: each completed window
            # advances the stream's virtual finish time like a fresh
            # admission, so a long stream keeps paying for capacity
            # instead of riding one admission forever
            session.on_step = self.queue.charge_step
        self.queue.submit(session)
        with self._lock:
            self._sessions[session.sid] = session
            self._submitted += 1
            self._wake.notify_all()
        _metrics.REGISTRY.inc("serve_sessions_total")
        _metrics.REGISTRY.set_gauge("serve_queue_depth",
                                    self.queue.stats()["queued"])

    # -- scheduling -------------------------------------------------------
    def _schedule_loop(self):
        while True:
            with self._lock:
                if self._stopping and self._running == 0:
                    return
                free = self._running < self.options.max_running \
                    and not self._stopping
            popped = self.queue.pop() if free else None
            if popped is not None:
                with self._lock:
                    self._running += 1
                    self._slots.add(popped.sid)
                _metrics.REGISTRY.set_gauge("serve_sessions_active",
                                            self._running_snapshot())
                t = threading.Thread(target=self._run_session,
                                     args=(popped,), daemon=True,
                                     name=f"serve-{popped.sid}")
                t.start()
                self._note_thread(t)
                continue
            self._reap_deadlines()
            with self._lock:
                if self._stopping and self._running == 0:
                    return
                self._wake.wait(timeout=0.05)

    def _running_snapshot(self) -> int:
        with self._lock:
            return self._running

    # -- bounded registries (a long-lived server must not grow with
    # total sessions served) ----------------------------------------------
    def _note_thread(self, t) -> None:
        """Track a worker/reader thread, dropping finished ones — the
        list stays O(live threads), not O(lifetime threads)."""
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _prune_sessions(self) -> None:
        """Fold the oldest terminal sessions into the state-total
        counters once more than keep_terminal of them accumulate; live
        sessions are never touched.  stats() merges the counters, so
        accounting survives the prune."""
        with self._lock:
            terminal = [s for s in self._sessions.values()
                        if s.is_terminal()]
            excess = len(terminal) - max(0, int(self.keep_terminal))
            for s in terminal[:max(0, excess)]:
                self._state_totals[s.state] = \
                    self._state_totals.get(s.state, 0) + 1
                del self._sessions[s.sid]

    def _reap_deadlines(self):
        """Typed deadline enforcement (docs/serving.md failure
        semantics): a session past its deadline — queued OR running —
        settles `failed` (reason deadline) NOW; a hung worker is
        abandoned to drain in the background, its quota freed, exactly
        the dispatch-timeout contract one layer up.

        STREAMING sessions: a healthy MPC stream outlives
        any whole-session wall clock by design, so once it is RUNNING
        (or DEGRADED mid-resume) its liveness unit is the STEP —
        reaped only after step_miss_budget consecutive per-step
        deadlines (spec.step_deadline_s, re-armed by every completed
        window) pass without a step.  deadline_s still bounds its
        QUEUED wait like any other session."""
        now = time.perf_counter()
        budget = max(1, int(self.options.step_miss_budget))
        with self._lock:
            sessions = [s for s in self._sessions.values()
                        if not s.is_terminal()]
        for s in sessions:
            state = s.state
            live = state in (sess_mod.RUNNING, sess_mod.DEGRADED)
            if s.streaming and live:
                missed = s.steps_overdue(now)
                if missed < budget:
                    continue
                if s.settle("failed", reason="step-deadline",
                            detail=f"{missed} consecutive step "
                                   f"deadlines "
                                   f"({s.spec.step_deadline_s}s) "
                                   f"missed at step {s.mpc_step}"):
                    _metrics.REGISTRY.inc("serve_failures_total")
                self._release(s)
            elif s.deadline is not None and now >= s.deadline:
                if s.settle("failed", reason="deadline",
                            detail=f"session deadline "
                                   f"{s.spec.deadline_s}s expired in "
                                   f"{state}"):
                    _metrics.REGISTRY.inc("serve_failures_total")
                if live:
                    self._release(s)

    def _release(self, session):
        """Free the session's worker slot + tenant quota exactly once
        — the deadline reaper and the worker's own exit path can both
        reach here for the same admission (a reaped session's
        abandoned worker still unwinds through its finally)."""
        with self._lock:
            if session.sid not in self._slots:
                return
            self._slots.discard(session.sid)
            self._running = max(0, self._running - 1)
            self._wake.notify_all()
        self.queue.release(session)
        _metrics.REGISTRY.set_gauge("serve_sessions_active",
                                    self._running_snapshot())
        # the queue gauge moves on pops/drains too, not only submits —
        # a monitoring consumer must never read a drained queue as
        # still flood-deep
        _metrics.REGISTRY.set_gauge("serve_queue_depth",
                                    self.queue.stats()["queued"])

    # -- the session worker -----------------------------------------------
    def _run_session(self, session):
        plan = self.options.fault_plan
        released = False
        try:
            if session.is_terminal():
                return       # reaped while queued
            if session.state == sess_mod.QUEUED:
                session.transition(sess_mod.ADMITTED)
            # a re-admitted DEGRADED session goes straight back to
            # RUNNING (preemption-resume path)
            if plan is not None and plan.serve_drop_connection(
                    session.tenant, session.ordinal):
                # injected mid-run disconnect: the session keeps
                # running detached; accounting and the per-session
                # trace stay intact
                session.detach()
                _metrics.REGISTRY.inc("serve_disconnects_total")
            session.transition(sess_mod.RUNNING,
                               restore=session.restore)
            # one causal segment span per run attempt:
            # everything the engine/hub emits below rides this span;
            # a resumed attempt opens a sibling under the same root
            session.begin_segment()
            session.t_started = session.t_started \
                or time.perf_counter()
            if session.streaming:
                # queue/preemption time must not bill against the
                # first step's per-step deadline
                session.reset_step_anchor()
            verdict, payload = self.engine.run(
                session, ring=self.ring, fault_plan=plan)
            if verdict == "preempted":
                # free the slot BEFORE requeueing: the scheduler may
                # re-admit the session the moment it hits the queue
                released = True
                self._release(session)
                self._handle_preemption(session, payload)
                return
            session.settle("done", **payload)
        except Exception as e:  # noqa: BLE001 — typed for the client
            reason = getattr(e, "reason", None) or type(e).__name__
            if session.settle("failed", reason=str(reason),
                              detail=str(e)[:500]):
                # settle returns False when the deadline reaper got
                # here first — the failure then counted already
                _metrics.REGISTRY.inc("serve_failures_total")
        finally:
            if not released:
                self._release(session)
            self._prune_sessions()

    def _handle_preemption(self, session, payload: dict):
        """A preempted session re-enters the queue FRONT with
        restore=True — the emergency snapshot is already on disk, so
        the resumed run continues mid-loop with no client-visible
        state loss (the client sees a non-terminal 'preempted' line,
        then the stream resumes).  A server already draining settles
        the session typed instead: nothing would ever pop the requeue
        once the scheduler loop exits."""
        session.preemptions += 1
        with self._lock:
            self._preemptions += 1
            stopping = self._stopping
        _metrics.REGISTRY.inc("serve_preemptions_total")
        session.transition(sess_mod.DEGRADED, reason="preempted",
                           **payload)
        session.send({"event": "preempted", "session": session.sid,
                      **payload})
        # the preempted attempt's segment span detaches here; the
        # restore (local requeue or fleet migration) opens a sibling
        # under the same trace — the wall gap between them IS the
        # migration gap on the critical path
        session.end_segment()
        session.restore = True
        if stopping:
            session.settle("failed", reason="draining",
                           detail="preempted while the server "
                                  "drained; checkpoint retained")
            return
        if self._preemption_handoff(session, payload):
            return          # the fleet router took ownership
        self.queue.requeue_front(session)
        with self._lock:
            stopping = self._stopping
            self._wake.notify_all()
        if stopping:
            # the server began draining BETWEEN our first check and
            # the requeue: the scheduler loop may already be gone, so
            # drain from here — every queued session (including this
            # one) still gets its typed terminal outcome
            for s in self.queue.drain():
                self._reject(s, "draining")

    def _preemption_handoff(self, session, payload: dict) -> bool:
        """Fleet seam: a replica server overrides this to
        hand a draining/migrating session back to its router instead
        of the local queue.  True = the router took ownership (the
        emergency checkpoint is on disk; the router re-places the
        session with restore=True on another replica)."""
        return False

    # -- health probes ----------------------------------------------------
    def load(self) -> tuple[int, int]:
        """(running, queued) — the router's cheap placement read."""
        with self._lock:
            running = self._running
        return running, self.queue.stats()["queued"]

    def status(self) -> dict:
        """Lightweight health probe: replica
        identity, session counts by state, queue depth, free slots,
        and the interner digests this replica's engine holds — the
        placement-affinity key the fleet router routes on.  Cheap
        enough to answer on every heartbeat probe."""
        with self._lock:
            running = self._running
            stopping = self._stopping
            states: dict = dict(self._state_totals)
            for s in self._sessions.values():
                states[s.state] = states.get(s.state, 0) + 1
        q = self.queue.stats()
        out = {
            "replica": self.options.replica_id,
            "running": running,
            "queued": q["queued"],
            "free_slots": max(0, self.options.max_running - running),
            "draining": stopping or bool(q.get("draining")),
            "states": states,
        }
        interner = getattr(self.engine, "interner", None)
        out["interner_digests"] = (
            list(interner.digests())
            if interner is not None and hasattr(interner, "digests")
            else [])
        return out

    # -- stats ------------------------------------------------------------
    def stats(self) -> dict:
        from mpisppy_tpu_torch import dispatch as _dispatch
        with self._lock:
            counts = dict(self._state_totals)   # pruned terminal tail
            for s in self._sessions.values():
                counts[s.state] = counts.get(s.state, 0) + 1
            out = {
                "submitted": self._submitted,
                "running": self._running,
                "preemptions": self._preemptions,
                "states": counts,
            }
        out["admission"] = self.queue.stats()
        if self.ring is not None:
            out["exchange_ring"] = self.ring.stats()
        ds = _dispatch.scheduler_stats()
        if ds is not None:
            out["dispatch"] = {
                "batches": ds["batches"],
                "coalesced_lanes": ds["coalesced_lanes"],
                "occupancy": ds["occupancy"],
                "by_key": ds["by_key"],
            }
        return out
