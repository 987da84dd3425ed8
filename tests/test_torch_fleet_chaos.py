# Port parity: the fleet chaos storm of tests/test_fleet_chaos.py on the
# port's router (mpisppy_tpu_torch/fleet/, device="cpu"): seeded
# replica-fault mixes
# — kill one replica mid-traffic, slow another's heartbeat — against a
# running 3-replica FleetRouter with live traffic.  The fleet
# invariant under all of it: every submitted session observes EXACTLY
# ONE terminal outcome (the settle latch holds across the migration
# hand-off), killed-replica sessions live-migrate and finish (zero
# migrations lost), the dead replica is fenced, and global quotas are
# fully restored.  The fast two-seed storm, with fixed seeds; the kill
# waits until the doomed replica runs a session, so a slow start of the
# clients cannot leave it idle.
import json
import threading
import time

import numpy as np
import pytest

from mpisppy_tpu_torch.fleet import DEAD, FleetOptions, FleetRouter
from mpisppy_tpu_torch.resilience.faults import FaultPlan, ReplicaFault
from mpisppy_tpu_torch.serve import SubmitRequest
from mpisppy_tpu_torch.serve import loadgen
from mpisppy_tpu_torch.serve.engine import SyntheticEngine

pytestmark = pytest.mark.chaos


class _KillUnderLoad(FaultPlan):
    """The storm's plan, with the kill held until the doomed replica runs
    a session: on a loaded host the clients can connect after the kill's
    beat, and a replica killed idle migrates nothing."""

    router = None

    def replica_kill(self, rid, beat):
        r = self.router
        if r is None or not any(s.state == "RUNNING"
                                for s in r.assigned_to(rid)):
            return False
        return super().replica_kill(rid, beat)


def run_fleet_storm(seed: int, tmp_path) -> dict:
    """One seeded storm round: 3 replicas, 6 concurrent slots, all
    busy when a seed-chosen replica dies (its beat loop stops a few
    beats in) and a second replica turns slow-but-alive.  Healthy
    tenants acme/zeta stream their sessions to terminal through it
    all."""
    rng = np.random.default_rng(seed)
    kill_rid = f"r{int(rng.integers(0, 3))}"
    slow_rid = f"r{(int(kill_rid[1:]) + 1) % 3}"
    plan = _KillUnderLoad(seed=seed, replicas=(
        ReplicaFault("kill", replica=kill_rid,
                     at_beats=(int(rng.integers(3, 6)),)),
        ReplicaFault("slow_heartbeat", replica=slow_rid,
                     delay_s=0.15),
    ))
    router = FleetRouter(FleetOptions(
        unix_path=str(tmp_path / f"fleet{seed}.sock"),
        n_replicas=3, max_running_per_replica=2,
        max_queued=32, max_queued_per_tenant=16, tenant_quota=4,
        trace_dir=str(tmp_path / f"traces{seed}"),
        spool_dir=str(tmp_path / f"spool{seed}"),
        heartbeat_s=0.05, drain_grace_s=10.0,
        default_deadline_s=30.0,
        engine_factory=lambda rid: SyntheticEngine(iters=40,
                                                   step_s=0.02),
        fault_plan=plan, device="cpu")).start()
    plan.router = router

    records: list = []
    rec_lock = threading.Lock()

    def client(tenant):
        cl = loadgen.ServeClient(router.address, timeout=45.0)
        try:
            for k in range(2):
                rec = loadgen.run_session(cl, SubmitRequest(
                    tenant=tenant, model="farmer", num_scens=3,
                    sla="latency" if k == 0 else "throughput"))
                with rec_lock:
                    records.append(rec)
        finally:
            cl.close()

    threads = [threading.Thread(target=client, args=(t,))
               for t in ("acme", "acme", "acme", "zeta", "zeta",
                         "zeta")]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    wall = time.perf_counter() - t0
    alive = [t.name for t in threads if t.is_alive()]
    # settle server-side terminal accounting before the asserts: a
    # session's terminal line reaches its client before its settle hook
    # gives the global quota back (Session.settle), so wait for both
    deadline = time.perf_counter() + 15.0
    while time.perf_counter() < deadline:
        st = router.stats()
        nonterminal = sum(v for k, v in st["states"].items()
                          if k not in ("DONE", "FAILED", "REJECTED"))
        charged = sum(t["inflight"]
                      for t in st["admission"]["tenants"].values())
        if nonterminal == 0 and st["assigned"] == 0 and charged == 0:
            break
        time.sleep(0.05)
    stats = router.stats()
    sessions = dict(router._sessions)
    router.stop()
    fleet_log = tmp_path / f"traces{seed}" / "fleet.jsonl"
    rows = [json.loads(ln)
            for ln in fleet_log.read_text().splitlines()]
    return {"seed": seed, "plan": plan, "kill_rid": kill_rid,
            "records": records, "stats": stats, "wall": wall,
            "alive": alive, "sessions": sessions, "rows": rows,
            "trace_dir": str(tmp_path / f"traces{seed}")}


def assert_fleet_storm_invariants(r: dict) -> None:
    seed = r["seed"]
    assert not r["alive"], \
        f"DEADLOCK: {r['alive']} still alive (seed {seed})"
    # every client record terminal; healthy traffic all DONE (caps are
    # wide, the only disruption is the replica fault mix)
    assert len(r["records"]) == 12
    for rec in r["records"]:
        assert rec["outcome"] == "done", (seed, rec)
    # the kill fired and the replica is fenced
    assert any(s == "replica" and
               d.startswith(f"kill {r['kill_rid']}@")
               for s, d in r["plan"].fired), r["plan"].fired
    assert r["stats"]["health"][r["kill_rid"]] == DEAD
    # live migration exercised, nothing lost
    mig = r["stats"]["migration"]
    assert mig["started"] >= 1, \
        f"seed {seed}: kill landed after traffic, nothing migrated"
    assert mig["completed"] == mig["started"]
    assert mig["lost"] == 0
    # EXACTLY ONE terminal session-state row per session fleet-wide —
    # the exactly-once delivery contract across the hand-off races
    terminals: dict = {}
    for row in r["rows"]:
        d = row.get("data", {})
        if row["kind"] == "session-state" and \
                d.get("state") in ("DONE", "FAILED", "REJECTED"):
            terminals[d["session"]] = terminals.get(d["session"], 0) + 1
    assert len(terminals) == 12
    assert all(n == 1 for n in terminals.values()), \
        (seed, {k: v for k, v in terminals.items() if v > 1})
    # every server-side session terminal; global quota fully restored
    for s in r["sessions"].values():
        assert s.state in ("DONE", "FAILED", "REJECTED"), \
            (seed, s.sid, s.tenant, s.state)
    for name, t in r["stats"]["admission"]["tenants"].items():
        assert t["inflight"] == 0, (seed, name, t)
    assert r["wall"] < 60.0


def assert_trace_continuity(r: dict) -> None:
    """A live-migrated session's trace is ONE
    causal tree across the replica hand-off — zero orphan spans, the
    migration span on the critical path, and the bucket partition
    covering the client-observed latency within the 5% line."""
    from mpisppy_tpu_torch.telemetry import spans

    seed = r["seed"]
    # twelve clients, twelve distinct traces, minted at submit
    trace_by_sid = {rec["session"]: rec["trace_id"]
                    for rec in r["records"]}
    assert len(set(trace_by_sid.values())) == 12
    # sessions that LIVE-migrated (queued re-dispatches never started,
    # so there is no segment to stitch)
    migrated = {row["data"]["session"] for row in r["rows"]
                if row["kind"] == "session-migrated"
                and not row["data"].get("queued")}
    assert migrated, f"seed {seed}: no live migration in the storm"
    rows = spans.load_rows(r["trace_dir"])
    for sid in sorted(migrated):
        rep = spans.assemble(rows, trace_by_sid[sid])
        assert rep["orphans"] == [], (seed, sid, rep["orphans"])
        names = [sp["name"] for sp in rep["spans"]]
        assert names[0] == "request", (seed, sid, names)
        assert "migration" in names, (seed, sid, names)
        assert rep["migrated_segments"] >= 1, (seed, sid)
        cp = rep["critical_path"]
        assert cp["buckets"].get("migration-gap", 0) > 0, \
            (seed, sid, cp["buckets"])
        assert cp["client_total_s"] is not None, (seed, sid)
        assert abs(cp["coverage"] - 1.0) <= 0.05, (seed, sid, cp)


@pytest.mark.parametrize("seed", [7, 31])
def test_fleet_chaos_kill_replica_fast_seeded(tmp_path, seed):
    """Two seeded storms (~8 s wall each)."""
    r = run_fleet_storm(seed, tmp_path)
    assert_fleet_storm_invariants(r)
    assert_trace_continuity(r)
