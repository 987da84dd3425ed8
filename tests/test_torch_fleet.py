# Port parity: the wheel fleet (mpisppy_tpu_torch/fleet/) against the JAX
# package's (mpisppy_tpu/fleet/) on the CPU — the cases of
# tests/test_fleet.py, plus:
#   * routing keys equal to the JAX keys on the same requests (computed
#     from the client's args, before the server appends --device);
#   * placement, pop_placed and the health ladder driven by the same
#     sequences in both packages;
#   * one real WheelEngine session (sslp 5x15, S=8) whose replica is killed
#     after hub iteration 2: it migrates through the shared spool and
#     ends on the other replica bit for bit where its unmigrated run
#     ends, and within 1e-3 of the JAX package's unmigrated session;
#   * an L-shaped session (no restorable state) fails typed when its
#     replica dies instead of crashing or restarting;
#   * the router raises without CUDA unless given device="cpu", and a
#     JAX client drives the port router over its socket.
import json
import os
import threading
import time

import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu.fleet import health as jhealth
from mpisppy_tpu.fleet import placement as jplace
from mpisppy_tpu.serve import admission as jadm
from mpisppy_tpu.serve import engine as jeng
from mpisppy_tpu.serve import loadgen as jloadgen
from mpisppy_tpu.serve import protocol as jproto
from mpisppy_tpu.serve import session as jsess
from mpisppy_tpu_torch.cylinders.hub import CheckpointUnsupported
from mpisppy_tpu_torch.fleet import (
    DEAD, SUSPECT, UP, FleetOptions, FleetRouter, HealthBoard, choose,
    routing_key,
)
from mpisppy_tpu_torch.resilience.faults import FaultPlan, ReplicaFault
from mpisppy_tpu_torch.serve import FleetAdmission, SubmitRequest
from mpisppy_tpu_torch.serve import loadgen
from mpisppy_tpu_torch.serve.engine import (
    SyntheticEngine, WheelEngine, session_argv,
)
from mpisppy_tpu_torch.serve.session import Session

torch.set_num_threads(1)

JAX_REL = 1e-3     # the migrated session against the JAX package's


def _spec(tenant="acme", **kw):
    kw.setdefault("model", "farmer")
    kw.setdefault("num_scens", 3)
    return SubmitRequest(tenant=tenant, **kw)


def _sess(tenant="acme", **kw):
    s = Session(_spec(tenant, **kw))
    s.structure_key = routing_key(s.spec)
    return s


class _FakeReplica:
    """Placement test double: id + free slots + held keys."""

    def __init__(self, rid, free=1, keys=()):
        self.id = rid
        self._free = free
        self._keys = set(keys)

    def free_slots(self):
        return self._free

    def holds(self, key):
        return key in self._keys


class KillUnderLoad(FaultPlan):
    """A plan whose replica kill waits until the doomed replica runs a
    session (on a loaded host the clients may connect after the kill's
    beat, and a replica killed idle migrates nothing)."""

    router = None

    def replica_kill(self, rid, beat):
        r = self.router
        if r is None or not any(s.state == "RUNNING"
                                for s in r.assigned_to(rid)):
            return False
        return super().replica_kill(rid, beat)


class KillAfterIter(FaultPlan):
    """A ReplicaFault("kill") on `rid` armed once a session's hub reaches
    the sync of hub iteration `at`; that sync then waits until the drain
    has set the session's preempt_event, so the next sync raises — the
    migration lands at one hub iteration on every run."""

    def __init__(self, rid: str, at: int, sessions, wait_s: float = 60.0):
        super().__init__(replicas=(ReplicaFault("kill", replica=rid),))
        self.at, self.sessions, self.wait_s = at, sessions, wait_s
        self.gate = threading.Event()

    def replica_kill(self, rid, beat):
        return self.gate.is_set() and super().replica_kill(rid, beat)

    def maybe_preempt(self, hub_iter):
        super().maybe_preempt(hub_iter)
        if hub_iter != self.at or self.gate.is_set():
            return
        self.gate.set()
        deadline = time.perf_counter() + self.wait_s
        while time.perf_counter() < deadline and not any(
                s.preempt_event.is_set() for s in self.sessions()):
            time.sleep(0.01)


# ---------------------------------------------------------------------------
# placement: the JAX keys and choices
# ---------------------------------------------------------------------------
SPECS = [dict(model="farmer", num_scens=3),
         dict(model="farmer", num_scens=4),
         dict(model="sslp", num_scens=16, args=("--sslp-lp-relax",)),
         dict(model="uc", num_scens=3, args=("--uc-n-gens", "2")),
         dict(model="ccopf", num_scens=9, args=("--soc",))]


@pytest.mark.parametrize("kw", SPECS)
def test_routing_key_equals_jax(kw):
    """The key hashes the client's spec (model, scale, args): the port's
    equals the JAX key on the same request, and the device the server
    appends to the argv (session_argv) is not part of it."""
    spec = SubmitRequest(tenant="acme", **kw)
    jspec = jproto.SubmitRequest.from_dict(spec.to_dict())
    assert routing_key(spec) == jplace.routing_key(jspec)
    assert session_argv(spec, False, "cpu")[-2:] == ["--device", "cpu"]
    assert "--device" not in spec.args


def test_routing_key_is_structure_content_addressed():
    a = routing_key(_spec("acme", num_scens=4))
    b = routing_key(_spec("zeta", num_scens=4))     # tenant-agnostic
    c = routing_key(_spec("acme", num_scens=5))
    d = routing_key(_spec("acme", num_scens=4, args=("--x", "1")))
    assert a == b
    assert a != c and a != d


def test_placement_prefers_affinity_then_least_loaded():
    """The same candidate sets through both packages' choose."""
    s = _sess("acme", num_scens=4)
    js = jsess.Session(jproto.SubmitRequest.from_dict(s.spec.to_dict()))
    js.structure_key = s.structure_key
    key = s.structure_key
    cases = [
        [_FakeReplica("r0", free=1, keys=(key,)), _FakeReplica("r1", 3)],
        [_FakeReplica("r0", 1), _FakeReplica("r1", 3)],
        [_FakeReplica("r0", 2), _FakeReplica("r1", 2)],
        [_FakeReplica("r0", 2, keys=(key,)),
         _FakeReplica("r1", 1, keys=(key,)), _FakeReplica("r2", 5)],
        [],
    ]
    got = []
    for cands in cases:
        rep, policy = choose(s, cands)
        jrep, jpolicy = jplace.choose(js, cands)
        assert rep is jrep and policy == jpolicy
        got.append((getattr(rep, "id", None), policy))
    assert got == [("r0", "affinity"), ("r1", "least-loaded"),
                   ("r1", "least-loaded"), ("r0", "affinity"),
                   (None, "none")]


# ---------------------------------------------------------------------------
# fused WFQ pop + placement
# ---------------------------------------------------------------------------
def test_pop_placed_sequence_equals_jax():
    """One seeded sequence of submits, declined and accepted placements
    and releases through both packages' FleetAdmission: the same pops,
    the same charges."""
    rng = np.random.default_rng(3)
    queues = {"torch": FleetAdmission(max_queued=16, default_quota=2,
                                      weights={"acme": 2.0}),
              "jax": jadm.FleetAdmission(max_queued=16, default_quota=2,
                                         weights={"acme": 2.0})}
    made = {"torch": [], "jax": []}
    for i in range(10):
        tenant = ("acme", "zeta", "omni")[int(rng.integers(0, 3))]
        sla = ("latency", "throughput")[int(rng.integers(0, 2))]
        spec = _spec(tenant, sla=sla, num_scens=3 + i)
        for pkg, q in queues.items():
            s = Session(spec) if pkg == "torch" else jsess.Session(
                jproto.SubmitRequest.from_dict(spec.to_dict()))
            made[pkg].append(s)
            q.submit(s)
    log = {"torch": [], "jax": []}
    for step in range(14):
        accept = bool(rng.integers(0, 3))
        release = int(rng.integers(0, 2))
        for pkg, q in queues.items():
            got, rep = q.pop_placed(
                lambda _s, a=accept: _FakeReplica("r0") if a else None)
            log[pkg].append(None if got is None
                            else made[pkg].index(got))
            if release and got is not None:
                q.release(got)
    assert log["torch"] == log["jax"]
    ts, js = queues["torch"].stats(), queues["jax"].stats()
    for t in ts["tenants"]:
        for f in ("queued", "inflight", "admitted"):
            assert ts["tenants"][t][f] == js["tenants"][t][f], (t, f)


def test_pop_placed_declined_placement_leaves_session_uncharged():
    q = FleetAdmission(max_queued=8, default_quota=2)
    s = _sess("acme")
    q.submit(s)
    got, rep = q.pop_placed(lambda _s: None)
    assert got is None and rep is None
    st = q.stats()["tenants"]["acme"]
    assert st["queued"] == 1 and st["inflight"] == 0
    target = _FakeReplica("r0", free=1)
    got, rep = q.pop_placed(lambda _s: target)
    assert got is s and rep is target
    st = q.stats()["tenants"]["acme"]
    assert st["queued"] == 0 and st["inflight"] == 1


def test_pop_placed_aborts_when_drain_races_the_candidate():
    q = FleetAdmission(max_queued=8, default_quota=2)
    s = _sess("acme")
    q.submit(s)

    def place(sess):
        drained = q.drain()            # the race, deterministically
        assert drained == [s]
        return _FakeReplica("r0", free=1)

    got, rep = q.pop_placed(place)
    assert got is None and rep is None
    assert q.stats()["tenants"]["acme"]["inflight"] == 0


# ---------------------------------------------------------------------------
# health board
# ---------------------------------------------------------------------------
def test_health_ladder_equals_jax():
    """The same observe/force sequence through both boards: the same
    transitions, the same sticky DEAD."""
    seq = [("observe", "r0", False, True), ("observe", "r0", True, None),
           ("observe", "r1", False, True), ("force", "r1", DEAD, None),
           ("observe", "r1", True, None), ("observe", "r0", False, False),
           ("observe", "r0", True, None), ("observe", "r2", True, None)]
    boards = (HealthBoard(), jhealth.HealthBoard())
    outs = ([], [])
    for op, rid, a, b in seq:
        for board, out in zip(boards, outs):
            if op == "observe":
                out.append(board.observe(rid, a, b))
            else:
                out.append(board.force(rid, a))
    assert outs[0] == outs[1]
    assert boards[0].snapshot() == boards[1].snapshot() \
        == {"r0": DEAD, "r1": DEAD}
    hb = HealthBoard()
    assert hb.observe("r0", fresh=False, probe_ok=True) == SUSPECT
    assert hb.observe("r0", fresh=True) == UP


# ---------------------------------------------------------------------------
# router end-to-end (SyntheticEngine replicas over real sockets)
# ---------------------------------------------------------------------------
def _start_fleet(tmp_path, n=2, iters=8, step_s=0.01, fault_plan=None,
                 **opts_kw):
    opts_kw.setdefault("trace_dir", str(tmp_path / "traces"))
    opts_kw.setdefault("spool_dir", str(tmp_path / "spool"))
    opts_kw.setdefault("heartbeat_s", 0.05)
    return FleetRouter(FleetOptions(
        n_replicas=n, max_running_per_replica=2,
        engine_factory=lambda rid: SyntheticEngine(iters=iters,
                                                   step_s=step_s),
        fault_plan=fault_plan, device="cpu", **opts_kw)).start()


def _drive(router, n_sessions, timeout=30.0, tenants=("t0", "t1")):
    cl = loadgen.ServeClient(router.address, timeout=timeout)
    acks = [cl.submit(_spec(tenants[i % len(tenants)]))
            for i in range(n_sessions)]
    assert all(a.get("ok") for a in acks), acks
    terminal = {}
    for msg in cl.stream():
        if msg.get("event") in ("done", "failed", "rejected"):
            terminal.setdefault(msg["session"], []).append(msg)
            if len(terminal) == n_sessions:
                break
    cl.close()
    return terminal


def test_fleet_router_serves_and_reports(tmp_path):
    router = _start_fleet(tmp_path)
    try:
        terminal = _drive(router, 6)
        assert all(v[0]["event"] == "done" for v in terminal.values())
        cl = loadgen.ServeClient(router.address)
        cl.send({"op": "status"})
        st = cl.recv()["status"]
        assert set(st["replicas"]) == {"r0", "r1"}
        assert all(r["alive"] for r in st["replicas"].values())
        cl.send({"op": "stats"})
        stats = cl.recv()["stats"]
        assert stats["states"].get("DONE", 0) == 6
        assert stats["migration"]["lost"] == 0
        cl.close()
    finally:
        router.stop()
    fleet_log = tmp_path / "traces" / "fleet.jsonl"
    placements = [json.loads(ln) for ln in
                  fleet_log.read_text().splitlines()
                  if json.loads(ln)["kind"] == "fleet-placement"]
    assert len(placements) == 6
    for rid in {p["data"]["replica"] for p in placements}:
        assert list((tmp_path / "traces" / rid).glob("session-*.jsonl"))


def test_jax_client_drives_the_port_router(tmp_path):
    """The JSON-lines protocol byte for byte: the JAX package's client
    submits, pings, reads stats and status from a port router."""
    router = _start_fleet(tmp_path, iters=6)
    try:
        cl = jloadgen.ServeClient(router.address, timeout=30.0)
        rec = jloadgen.run_session(cl, jproto.SubmitRequest(
            tenant="acme", model="farmer", num_scens=3))
        assert rec["outcome"] == "done", rec
        cl.send({"op": "ping"})
        assert cl.recv() == {"ok": True, "op": "ping"}
        cl.send({"op": "status"})
        st = cl.recv()
        assert st["ok"] and set(st["status"]) == {
            "replicas", "queued", "assigned", "migration"}
        cl.send({"op": "nonsense"})
        assert cl.recv()["error"] == "unknown-op"
        cl.close()
    finally:
        router.stop()


def test_fleet_kill_replica_live_migrates_running_sessions(tmp_path):
    plan = KillUnderLoad(replicas=(
        ReplicaFault("kill", replica="r0", at_beats=(4,)),))
    router = _start_fleet(tmp_path, iters=40, step_s=0.02,
                          fault_plan=plan)
    plan.router = router
    try:
        terminal = _drive(router, 6, timeout=60.0)
        assert all(len(v) == 1 for v in terminal.values()), terminal
        assert all(v[0]["event"] == "done" for v in terminal.values())
        stats = router.stats()
        mig = stats["migration"]
        assert mig["started"] >= 1
        assert mig["completed"] == mig["started"]
        assert mig["lost"] == 0
        assert stats["health"]["r0"] == DEAD
    finally:
        router.stop()
    rows = [json.loads(ln) for ln in
            (tmp_path / "traces" / "fleet.jsonl")
            .read_text().splitlines()]
    migrated = {r["data"]["session"] for r in rows
                if r["kind"] == "session-migrated"}
    assert migrated
    terminals = {}
    for r in rows:
        if r["kind"] == "session-state" and \
                r["data"].get("state") in ("DONE", "FAILED", "REJECTED"):
            sid = r["data"]["session"]
            terminals[sid] = terminals.get(sid, 0) + 1
    assert all(n == 1 for n in terminals.values()), terminals
    sid = sorted(migrated)[0]
    assert (tmp_path / "traces" / "r0" / f"session-{sid}.jsonl").exists()
    assert (tmp_path / "traces" / "r1" / f"session-{sid}.jsonl").exists()


def test_fleet_partition_fences_and_drains(tmp_path):
    plan = FaultPlan(replicas=(
        ReplicaFault("partition", replica="r0",
                     at_beats=tuple(range(3, 100))),))
    router = _start_fleet(tmp_path, iters=40, step_s=0.02,
                          fault_plan=plan)
    try:
        terminal = _drive(router, 4, timeout=60.0)
        assert all(v[0]["event"] == "done" for v in terminal.values())
        stats = router.stats()
        assert stats["health"]["r0"] == DEAD
        assert stats["migration"]["lost"] == 0
        assert not router.replicas[0].alive()     # fenced for good
    finally:
        router.stop()


def test_fleet_slow_heartbeat_is_suspect_not_dead(tmp_path):
    plan = FaultPlan(replicas=(
        ReplicaFault("slow_heartbeat", replica="r0", delay_s=0.4),))
    router = _start_fleet(tmp_path, iters=10, step_s=0.01,
                          fault_plan=plan)
    try:
        terminal = _drive(router, 4, timeout=60.0)
        assert all(v[0]["event"] == "done" for v in terminal.values())
        time.sleep(0.5)                 # a few monitor cycles
        stats = router.stats()
        assert stats["health"].get("r0") in (None, UP, SUSPECT)
        assert stats["migration"]["started"] == 0
        assert router.replicas[0].alive()
    finally:
        router.stop()


def test_fleet_typed_backpressure_and_drain(tmp_path):
    router = _start_fleet(tmp_path, n=1, iters=200, step_s=0.02,
                          max_queued=2, max_queued_per_tenant=2,
                          tenant_quota=1)
    try:
        cl = loadgen.ServeClient(router.address, timeout=30.0)
        acks = [cl.submit(_spec("flood")) for _ in range(6)]
        rejected = [a for a in acks if not a.get("ok")]
        assert rejected
        assert all(a["error"] == "rejected" and a["reason"] in
                   ("queue-full", "tenant-queue-full")
                   for a in rejected)
        cl.close()
    finally:
        router.stop()
    assert all(s.is_terminal() for s in router._sessions.values())


def test_router_raises_without_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRouter(FleetOptions(n_replicas=1))
    r = FleetRouter(FleetOptions(
        n_replicas=1, device="cpu",
        engine_factory=lambda rid: SyntheticEngine()))
    assert r.replicas[0].server.options.device == "cpu"


# ---------------------------------------------------------------------------
# corrupted-destination restore: the migration target survives a
# corrupt newest snapshot via the rotation fallback
# ---------------------------------------------------------------------------
class _Cap:
    def __init__(self):
        self.events = []

    def handle(self, event):
        self.events.append(event)

    def close(self):
        pass


def test_migration_restore_falls_back_past_corrupt_newest(tmp_path):
    from mpisppy_tpu_torch.resilience.faults import SimulatedPreemption
    spool = tmp_path / "spool"
    spool.mkdir()
    path = str(spool / "ckpt-mig.npz")
    sess = Session(_spec(tenant="acme", gap_target=0.01,
                         max_iterations=150))
    sess.checkpoint_path = path
    src = WheelEngine(multiplexed=False, device="cpu")
    v, _ = src.run(sess, fault_plan=FaultPlan(seed=5, preempt_at_iter=3))
    assert v == "preempted"
    sess.restore = True
    v, _ = src.run(sess, fault_plan=FaultPlan(seed=5, preempt_at_iter=7))
    assert v == "preempted"
    assert os.path.exists(path) and os.path.exists(path + ".1")
    with np.load(path) as d:
        arrays = {k: np.array(d[k]) for k in d.files}
    arrays["leaf0"] = arrays["leaf0"] + 1.0
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    cap = _Cap()
    sess.bus.subscribe(cap)
    dst = WheelEngine(multiplexed=False, device="cpu")
    v, payload = dst.run(sess)
    assert v == "done"
    assert payload["rel_gap"] <= 0.01 + 1e-9
    restores = [e for e in cap.events if e.kind == "checkpoint-restore"]
    assert restores and restores[0].data.get("fallback") is True
    assert restores[0].data.get("path", "").endswith(".1")
    assert SimulatedPreemption is not None


# ---------------------------------------------------------------------------
# a real wheel session migrated between two replicas
# ---------------------------------------------------------------------------
def _real_fleet(tmp_path, plan):
    return FleetRouter(FleetOptions(
        unix_path=str(tmp_path / "fleet.sock"), n_replicas=2,
        max_running_per_replica=1, trace_dir=str(tmp_path / "traces"),
        spool_dir=str(tmp_path / "spool"), heartbeat_s=0.05,
        multiplex=False, default_deadline_s=240.0, fault_plan=plan,
        device="cpu")).start()


def test_real_session_migrates_and_ends_where_unmigrated_ends(tmp_path):
    """sslp 5x15 at S=8 through a two-replica router: r1 (least-loaded
    placement's tie-break) is killed after hub iteration 2, the session
    checkpoints into the shared spool, finishes on r0, and its progress
    rows after the resume and its final bounds equal the unmigrated
    run's bit for bit; the JAX package's unmigrated session agrees
    within JAX_REL."""
    spec = _spec(tenant="acme", model="sslp", num_scens=8,
                 gap_target=0.01, max_iterations=24,
                 args=("--n-servers", "5", "--n-clients", "15"))
    base = Session(spec)
    cap = _Cap()
    base.bus.subscribe(cap)
    # in a thread of its own, as a replica's worker runs a session: CPU
    # kernels split their work by the calling thread's thread count
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "r", WheelEngine(multiplexed=False, device="cpu").run(base)))
    t.start()
    t.join(timeout=240)
    assert not t.is_alive()
    _, want = out["r"]
    want_rows = {e.data["iter"]: e.data for e in cap.events
                 if e.kind == "hub-iteration"}
    router = None
    plan = KillAfterIter("r1", 2,
                         lambda: list(router._sessions.values()))
    router = _real_fleet(tmp_path, plan)
    lines = []
    try:
        cl = loadgen.ServeClient(router.address, timeout=240.0)
        ack = cl.submit(spec)
        assert ack.get("ok"), ack
        for msg in cl.stream():
            lines.append(msg)
            if msg.get("event") in ("done", "failed", "rejected"):
                break
        cl.close()
        stats = router.stats()
    finally:
        router.stop()
    done = [m for m in lines if m.get("event") == "done"]
    assert len(done) == 1, lines
    mig = stats["migration"]
    assert (mig["started"], mig["completed"], mig["lost"]) == (1, 1, 0)
    assert stats["health"]["r1"] == DEAD
    assert [m["iter"] for m in lines if m.get("event") == "preempted"] \
        == [3]
    assert any(m.get("event") == "restored" for m in lines)
    for f in ("outer", "inner", "rel_gap", "iterations"):
        assert done[0][f] == want[f], (f, done[0], want)
    # the destination's rows are the unmigrated run's rows
    p = tmp_path / "traces" / "r0" / f"session-{ack['session']}.jsonl"
    resumed = [json.loads(ln)["data"] for ln in p.read_text().splitlines()
               if json.loads(ln)["kind"] == "hub-iteration"]
    assert [r["iter"] for r in resumed] == list(
        range(4, want["iterations"] + 1))
    for r in resumed:
        w = want_rows[r["iter"]]
        for f in ("outer", "inner", "rel_gap", "conv"):
            assert r.get(f) == w.get(f), (r["iter"], f, r, w)
    # the JAX package's unmigrated session
    _, j = jeng.WheelEngine(multiplexed=False).run(jsess.Session(
        jproto.SubmitRequest.from_dict(spec.to_dict())))
    for f in ("outer", "inner"):
        assert abs(done[0][f] - j[f]) <= JAX_REL * abs(j[f]), (f, done, j)


def test_lshaped_checkpoint_refused_when_the_wheel_is_built(tmp_path):
    """The L-shaped method keeps no restorable state (its cut buffer
    grows every Benders iteration): --checkpoint-path with --lshaped-hub
    is refused at config time, and a hub built over it with a checkpoint
    path (a serve spool) raises the same typed error, so such a session
    fails typed (reason checkpoint-unsupported) instead of crashing at
    its first save."""
    from mpisppy_tpu_torch import generic_cylinders as gc
    from mpisppy_tpu_torch.algos.lshaped import LShapedMethod
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.cylinders.hub import LShapedHub
    from mpisppy_tpu_torch.models import farmer
    argv = ["--module-name", "mpisppy_tpu_torch.models.farmer",
            "--num-scens", "3", "--lshaped-hub", "--xhatlshaped",
            "--checkpoint-path", str(tmp_path / "ls.npz"),
            "--device", "cpu"]
    with pytest.raises(CheckpointUnsupported) as ei:
        gc.main(argv)
    assert ei.value.reason == "checkpoint-unsupported"
    assert not os.path.exists(tmp_path / "ls.npz")
    b = batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3)
         for nm in farmer.scenario_names_creator(3)], device="cpu")
    with pytest.raises(CheckpointUnsupported):
        LShapedHub(LShapedMethod({}, b),
                   {"checkpoint_path": str(tmp_path / "x.npz")})
