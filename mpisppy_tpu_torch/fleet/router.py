###############################################################################
# The fleet router (port of mpisppy_tpu/fleet/router.py;
# docs/serving.md fleet section).
#
# One admission tier over N serve replicas: clients speak the SAME
# JSON-lines protocol to the router socket (submit / ping / stats /
# status), but admission policy — WFQ weights, per-tenant quotas, SLA
# classes, bounded queues with typed rejection — lives HERE, in one
# FleetAdmission above the replicas.  The scheduler loop fuses the WFQ
# pop with placement (serve/admission.FleetAdmission.pop_placed +
# fleet/placement.choose): structure-affine first, least-loaded
# otherwise, and a fleet without free slots leaves the queue charged
# to nobody.
#
# Thread anatomy (every shared field lock-annotated; tools/graftlint
# lock-discipline):
#
#   acceptor ── one reader per client (same shape as serve/server.py)
#   scheduler ── pop_placed -> WheelServer.submit_session on the chosen
#     replica; doubles as the deadline reaper for sessions still queued
#     at the router (assigned sessions are reaped by their replica)
#   monitor ── ages the replicas' heartbeat clocks through the
#     HealthBoard; a stale replica is status-probed over its own
#     socket (alive-but-slow = SUSPECT, unreachable = DEAD -> fence,
#     drain, migrate)
#   drain threads ── one per dead replica: queued sessions requeue,
#     running sessions emergency-checkpoint and hand off (live
#     migration, fleet/migration.py), stragglers settle typed
#
# The exactly-one-terminal contract is unchanged from the single server: the
# same Session object travels router -> replica -> router -> replica, and
# its settle latch admits one delivery no matter how many paths race.
###############################################################################
from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time

from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.fleet import health, migration, placement
from mpisppy_tpu_torch.fleet import replica as replica_mod
from mpisppy_tpu_torch.serve import admission as adm
from mpisppy_tpu_torch.serve import protocol
from mpisppy_tpu_torch.serve import server as srv_mod
from mpisppy_tpu_torch.serve import session as sess_mod
from mpisppy_tpu_torch.telemetry import metrics as _metrics


@dataclasses.dataclass(frozen=True)
class FleetOptions:
    """Router + replica fleet knobs."""

    unix_path: str | None = None     # router socket (replica sockets
                                     # derive as <unix_path>.<rid>)
    host: str = "127.0.0.1"          # TCP fallback (replicas get
    port: int = 0                    # ephemeral ports)
    n_replicas: int = 3
    max_running_per_replica: int = 2
    max_queued: int = 64             # GLOBAL queue cap (router-owned)
    max_queued_per_tenant: int = 32
    tenant_quota: int = 2            # GLOBAL per-tenant in-flight cap
    tenant_weights: dict | None = None
    latency_burst: int = 4
    trace_dir: str | None = None     # replica traces land in <rid>/
                                     # subdirs; router events in
                                     # fleet.jsonl
    spool_dir: str | None = None     # SHARED checkpoint spool — the
                                     # migration transport
    multiplex: bool = True
    default_deadline_s: float | None = None
    heartbeat_s: float = 0.2
    miss_budget: int = 3             # stale beats before probing/death
    drain_grace_s: float = 5.0       # emergency-checkpoint window
    probe_timeout_s: float = 1.0
    engine_factory: object | None = None  # callable(rid) -> engine;
                                     # None = one WheelEngine with its
                                     # OWN StructureInterner per
                                     # replica (its own device stream's
                                     # structure pool)
    fault_plan: object | None = None
    bus: object | None = None
    device: str = "cuda"             # where every replica's sessions
                                     # run (ServeOptions.device); the
                                     # router raises without CUDA unless
                                     # given "cpu"


class FleetRouter:
    """See the module header."""

    def __init__(self, options: FleetOptions = FleetOptions()):
        replica_mod.check_device(options.device)
        self.options = options
        self.bus = options.bus or tel.EventBus()
        self.run_id = tel.new_run_id()
        for d in (options.trace_dir, options.spool_dir):
            if d:
                os.makedirs(d, exist_ok=True)
        if options.trace_dir:
            self.bus.subscribe(tel.JsonlSink(
                os.path.join(options.trace_dir, "fleet.jsonl")))
        self.admission = adm.FleetAdmission(
            max_queued=options.max_queued,
            max_queued_per_tenant=options.max_queued_per_tenant,
            default_quota=options.tenant_quota,
            weights=options.tenant_weights,
            latency_burst=options.latency_burst)
        self.migrator = migration.Migrator(self)
        self.board = health.HealthBoard(bus=self.bus,
                                        run_id=self.run_id)
        self._sock: socket.socket | None = None
        self.address = None
        # Lock discipline: registry,
        # assignment map and lifecycle flags are shared by the
        # acceptor, readers, scheduler, monitor, replica workers (via
        # on_terminal / hand-off) and drain threads.
        self._lock = threading.Lock()
        self._sessions: dict = {}         # guarded-by: _lock (live +
                                          # bounded terminal tail)
        self._assigned: dict = {}         # guarded-by: _lock
                                          # (sid -> replica id)
        self._state_totals: dict = {}     # guarded-by: _lock
        self._submitted = 0               # guarded-by: _lock
        self._stopping = False            # guarded-by: _lock
        self._downed: set = set()         # guarded-by: _lock
        self._threads: list = []          # guarded-by: _lock
        self._wake = threading.Condition(self._lock)
        self.keep_terminal = 256
        self.replicas: list = []
        for i in range(int(options.n_replicas)):
            rid = f"r{i}"
            self.replicas.append(replica_mod.Replica(
                rid, self._replica_options(rid),
                heartbeat_s=options.heartbeat_s,
                fault_plan=options.fault_plan,
                on_down=self._replica_down,
                router_handoff=self.migrator.hand_off))

    def _replica_options(self, rid: str) -> srv_mod.ServeOptions:
        o = self.options
        r_trace = os.path.join(o.trace_dir, rid) if o.trace_dir \
            else None
        engine = o.engine_factory(rid) if o.engine_factory else None
        if engine is None:
            from mpisppy_tpu_torch.serve import multiplex as mux
            from mpisppy_tpu_torch.serve.engine import WheelEngine
            engine = WheelEngine(
                multiplexed=o.multiplex,
                interner=mux.StructureInterner(), device=o.device)
        cap = max(2, int(o.max_running_per_replica))
        return srv_mod.ServeOptions(
            unix_path=f"{o.unix_path}.{rid}" if o.unix_path else None,
            host=o.host, port=0,
            max_running=o.max_running_per_replica,
            # the LOCAL queue is just the assignment buffer: caps wide
            # enough to never bind (global backpressure is the
            # router's), quota = slots so local WFQ never withholds
            max_queued=4 * cap, max_queued_per_tenant=4 * cap,
            tenant_quota=cap,
            latency_burst=o.latency_burst,
            trace_dir=r_trace, spool_dir=o.spool_dir,
            multiplex=o.multiplex,
            default_deadline_s=o.default_deadline_s,
            engine=engine, fault_plan=o.fault_plan,
            bus=self.bus, replica_id=rid, device=o.device)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "FleetRouter":
        for r in self.replicas:
            r.start()
        o = self.options
        if o.unix_path:
            try:
                os.unlink(o.unix_path)
            except OSError:
                pass
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(o.unix_path)
            self.address = o.unix_path
        else:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((o.host, o.port))
            self.address = s.getsockname()
        s.listen(64)
        s.settimeout(0.25)
        self._sock = s
        for name, target in (("fleet-accept", self._accept_loop),
                             ("fleet-sched", self._schedule_loop),
                             ("fleet-monitor", self._monitor_loop)):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._note_thread(t)
        _metrics.REGISTRY.set_gauge("fleet_replicas_up",
                                    len(self.replicas))
        tel.console.log(
            f"fleet: router on {self.address} "
            f"({len(self.replicas)} replicas x "
            f"{o.max_running_per_replica} slots)")
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._stopping = True
            self._wake.notify_all()
        for s in self.admission.drain():
            self._reject(s, "draining")
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                if not self._assigned:
                    break
            time.sleep(0.05)
        for r in self.replicas:
            r.close(timeout=1.0)
        # leftovers (a wedged worker on a replica we just closed):
        # typed terminal outcome, never a hang
        with self._lock:
            leftovers = [s for s in self._sessions.values()
                         if not s.is_terminal()]
        for s in leftovers:
            if s.settle("failed", reason="draining",
                        detail="fleet stopped before the session "
                               "finished"):
                _metrics.REGISTRY.inc("serve_failures_total")
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

    @property
    def stopping(self) -> bool:
        with self._lock:
            return self._stopping

    def kick(self) -> None:
        with self._lock:
            self._wake.notify_all()

    # -- client plumbing (same shape as serve/server.py) ------------------
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
                                 name="fleet-client")
            t.start()
            self._note_thread(t)

    def _client_loop(self, conn: socket.socket):
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
                    srv_mod.WheelServer._safe_send(outbox, {
                        "ok": False, "error": "malformed-json",
                        "detail": msg["_malformed"][:200]})
                    continue
                op = msg.get("op")
                if op == "ping":
                    srv_mod.WheelServer._safe_send(
                        outbox, {"ok": True, "op": "ping"})
                elif op == "stats":
                    srv_mod.WheelServer._safe_send(
                        outbox, {"ok": True, "op": "stats",
                                 "stats": self.stats()})
                elif op == "status":
                    srv_mod.WheelServer._safe_send(
                        outbox, {"ok": True, "op": "status",
                                 "status": self.status()})
                elif op == "submit":
                    try:
                        self._handle_submit(msg, outbox, my_sessions)
                    except Exception as e:  # noqa: BLE001 — typed ack
                        srv_mod.WheelServer._safe_send(outbox, {
                            "ok": False, "error": "internal",
                            "detail": f"{type(e).__name__}: "
                                      f"{e}"[:300]})
                else:
                    srv_mod.WheelServer._safe_send(outbox, {
                        "ok": False, "error": "unknown-op", "op": op})
        except (OSError, ValueError):
            pass
        finally:
            for s in my_sessions:
                s.detach()
            try:
                conn.close()
            except OSError:
                pass

    def _handle_submit(self, msg: dict, outbox, my_sessions: list):
        try:
            spec = protocol.SubmitRequest.from_dict(msg)
        except protocol.ProtocolError as e:
            srv_mod.WheelServer._safe_send(
                outbox, {"ok": False, "error": "bad-request",
                         "detail": str(e)})
            return
        if spec.deadline_s is None \
                and self.options.default_deadline_s is not None:
            spec = dataclasses.replace(
                spec, deadline_s=self.options.default_deadline_s)
        # the session's trace attaches per replica at assignment; the
        # checkpoint path is router-assigned so it stays STABLE across
        # replicas (the shared spool is the migration transport)
        session = sess_mod.Session(spec, outbox=outbox,
                                   server_bus=self.bus)
        session.structure_key = placement.routing_key(spec)
        if self.options.spool_dir:
            session.checkpoint_path = os.path.join(
                self.options.spool_dir, f"ckpt-{session.sid}.npz")
        try:
            self.admission.submit(session)
        except adm.AdmissionRejected as e:
            self.bus.emit(tel.ADMISSION_REJECTED, run=session.run_id,
                          cyl="serve", tenant=spec.tenant,
                          trace=session.trace,
                          reason=e.reason, detail=e.detail)
            _metrics.REGISTRY.inc("serve_admission_rejects_total")
            session.settle("rejected", reason=e.reason,
                           detail=e.detail)
            srv_mod.WheelServer._safe_send(
                outbox, {"ok": False, "session": session.sid,
                         "error": "rejected", "reason": e.reason})
            return
        with self._lock:
            self._sessions[session.sid] = session
            self._submitted += 1
            self._wake.notify_all()
        my_sessions.append(session)
        _metrics.REGISTRY.inc("serve_sessions_total")
        srv_mod.WheelServer._safe_send(
            outbox, {"ok": True, "session": session.sid,
                     "tenant": spec.tenant})

    def _reject(self, session, reason: str, detail: str = ""):
        if session.is_terminal():
            return
        if session.state == sess_mod.DEGRADED:
            session.settle("failed", reason=reason,
                           detail=detail or "migrating while the "
                           "fleet drained; checkpoint retained")
            return
        self.bus.emit(tel.ADMISSION_REJECTED, run=session.run_id,
                      cyl="serve", tenant=session.tenant,
                      trace=session.trace,
                      reason=reason, detail=detail)
        _metrics.REGISTRY.inc("serve_admission_rejects_total")
        session.settle("rejected", reason=reason, detail=detail)

    # -- scheduling: WFQ pop fused with placement -------------------------
    def _schedule_loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
            popped, rep = self.admission.pop_placed(self._place)
            if popped is not None:
                self._assign(popped, rep)
                continue
            self._reap_queued_deadlines()
            with self._lock:
                if self._stopping:
                    return
                self._wake.wait(timeout=0.05)

    def _place(self, session):
        candidates = [r for r in self.replicas
                      if r.alive() and r.free_slots() > 0]
        rep, policy = placement.choose(session, candidates)
        if rep is not None:
            session.placement_policy = policy
        return rep

    def _assign(self, session, rep) -> None:
        session.on_terminal = self._session_terminal
        with self._lock:
            self._assigned[session.sid] = rep.id
        try:
            rep.server.submit_session(session)
        except adm.AdmissionRejected:
            # the replica began draining between placement and submit:
            # undo the charge and let the scheduler re-place it
            self._unassign(session)
            if not self.stopping:
                self.admission.requeue_front(session)
            return
        rep.note_key(session.structure_key)
        policy = getattr(session, "placement_policy", "least-loaded")
        _metrics.REGISTRY.inc(
            "fleet_placement_affinity_total" if policy == "affinity"
            else "fleet_placement_spill_total")
        # stamped with the session's ROOT span: placement is a hop of
        # the request itself, not of any one run segment
        self.bus.emit(tel.FLEET_PLACEMENT, run=session.run_id,
                      cyl="fleet", session=session.sid,
                      trace=session.trace,
                      tenant=session.tenant, replica=rep.id,
                      policy=policy, key=session.structure_key,
                      migrations=session.migrations)

    def _unassign(self, session) -> None:
        """Drop the session's assignment and give its global quota
        charge back — exactly once per charge (the assignment entry is
        the latch)."""
        with self._lock:
            had = self._assigned.pop(session.sid, None) is not None
        if had:
            self.admission.release(session)

    def _session_terminal(self, session) -> None:
        self._unassign(session)
        self.kick()
        self._prune_sessions()

    def assigned_to(self, rid: str) -> list:
        with self._lock:
            return [self._sessions[sid]
                    for sid, r in self._assigned.items()
                    if r == rid and sid in self._sessions]

    def _reap_queued_deadlines(self) -> None:
        """Deadline enforcement for sessions still queued at the
        ROUTER (assigned sessions are reaped by their replica's own
        reaper)."""
        now = time.perf_counter()
        with self._lock:
            cands = [s for s in self._sessions.values()
                     if s.deadline is not None and now >= s.deadline
                     and not s.is_terminal()
                     and s.sid not in self._assigned]
        for s in cands:
            if s.settle("failed", reason="deadline",
                        detail=f"session deadline "
                               f"{s.spec.deadline_s}s expired queued "
                               f"at the router"):
                _metrics.REGISTRY.inc("serve_failures_total")

    # -- bounded registries -----------------------------------------------
    def _note_thread(self, t) -> None:
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _prune_sessions(self) -> None:
        with self._lock:
            terminal = [s for s in self._sessions.values()
                        if s.is_terminal()
                        and s.sid not in self._assigned]
            excess = len(terminal) - max(0, int(self.keep_terminal))
            for s in terminal[:max(0, excess)]:
                self._state_totals[s.state] = \
                    self._state_totals.get(s.state, 0) + 1
                del self._sessions[s.sid]

    # -- the health plane -------------------------------------------------
    def _monitor_loop(self):
        o = self.options
        while True:
            with self._lock:
                if self._stopping:
                    return
            time.sleep(o.heartbeat_s)
            for rep in self.replicas:
                if self.board.state(rep.id) == health.DEAD:
                    continue
                fresh = rep.beat_age() <= o.heartbeat_s * o.miss_budget
                probe_ok = None if fresh else self._probe(rep)
                new = self.board.observe(
                    rep.id, fresh, probe_ok,
                    reason="" if fresh else "missed-beats")
                if new == health.DEAD:
                    self._replica_down(rep, "missed-beats")

    def _probe(self, rep) -> bool:
        """Deep health check: the status op over the replica's own
        socket.  A partition suppresses it (the seam models the router
        side of the cut); a slow-but-alive replica answers."""
        plan = self.options.fault_plan
        if plan is not None \
                and plan.replica_partitioned(rep.id, rep.beats()):
            return False
        try:
            addr = rep.server.address
            if isinstance(addr, str):
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(addr)
            else:
                s = socket.create_connection(tuple(addr))
            try:
                s.settimeout(self.options.probe_timeout_s)
                s.sendall(protocol.encode({"op": "status"}))
                line = s.makefile("rb").readline()
            finally:
                s.close()
            if not line:
                return False
            import json
            return bool(json.loads(line).get("ok"))
        except (OSError, ValueError):
            return False

    def _replica_down(self, rep, reason: str) -> None:
        """Fence a dead replica and migrate its sessions — idempotent
        (the kill seam and the monitor can both get here)."""
        with self._lock:
            if rep.id in self._downed:
                return
            self._downed.add(rep.id)
        self.board.force(rep.id, health.DEAD, reason=reason)
        _metrics.REGISTRY.inc("fleet_replica_deaths_total")
        t = threading.Thread(target=self._drain_replica,
                             args=(rep, reason), daemon=True,
                             name=f"fleet-drain-{rep.id}")
        t.start()
        self._note_thread(t)

    def _drain_replica(self, rep, reason: str) -> None:
        grace = self.options.drain_grace_s
        rep.drain(self.migrator.requeue_queued, grace_s=grace)
        self.migrator.rescue(rep, grace_s=grace)
        _metrics.REGISTRY.set_gauge(
            "fleet_replicas_up",
            sum(1 for r in self.replicas if r.alive()))
        self.bus.emit(tel.REPLICA_STATE, run=self.run_id, cyl="fleet",
                      replica=rep.id, state="DRAINED", prev="DEAD",
                      reason=reason)
        self.kick()

    # -- stats / status ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            counts = dict(self._state_totals)
            for s in self._sessions.values():
                counts[s.state] = counts.get(s.state, 0) + 1
            out = {
                "submitted": self._submitted,
                "assigned": len(self._assigned),
                "states": counts,
            }
        out["admission"] = self.admission.stats()
        out["migration"] = self.migrator.counters()
        out["health"] = self.board.snapshot()
        out["replicas"] = {r.id: r.server.stats()
                          for r in self.replicas}
        return out

    def status(self) -> dict:
        """The fleet-level health summary (mirrors the per-replica
        status op one level up)."""
        with self._lock:
            assigned = len(self._assigned)
        return {
            "replicas": {
                r.id: {"state": self.board.state(r.id),
                       "alive": r.alive(),
                       "free_slots": r.free_slots(),
                       "beats": r.beats()}
                for r in self.replicas},
            "queued": self.admission.stats()["queued"],
            "assigned": assigned,
            "migration": self.migrator.counters(),
        }
