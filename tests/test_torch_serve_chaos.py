# Port of the serve-layer chaos storm (tests/test_serve_chaos.py) on the
# port's WheelServer (mpisppy_tpu_torch/serve/) with SyntheticEngine: a
# seeded mix of ServeFaults (hang / poison / disconnect / flood), a
# kill-dispatcher storm on a dispatch scheduler beside it and a
# preemption mid-traffic.  The invariant under all of it: every submitted
# session observes exactly one terminal outcome (result, typed failure or
# typed rejection), never a hang; tenant quotas are fully restored; the
# server survives.  Two seeds in tier-1, the 12-seed soak under `slow`,
# as in the JAX package.
import dataclasses
import socket
import threading
import time

import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.dispatch import (
    DispatchOptions, SolveFailed, SolveScheduler,
)
from mpisppy_tpu_torch.ops.bnb import BnBResult
from mpisppy_tpu_torch.resilience import DispatchFault, FaultPlan, ServeFault
from mpisppy_tpu_torch.serve import ServeOptions, SubmitRequest, WheelServer
from mpisppy_tpu_torch.serve import loadgen
from mpisppy_tpu_torch.serve.engine import SyntheticEngine

from test_mip_bnb import random_mips

pytestmark = pytest.mark.chaos

torch.set_num_threads(1)


def _fake_solve(qp, d_col, int_cols, opts, **kw):
    time.sleep(0.002)
    S = qp.c.shape[0]
    inner = qp.c.sum(dim=-1)
    return BnBResult(x=torch.zeros_like(qp.c), inner=inner,
                     outer=inner - 1.0, gap=torch.zeros(S),
                     feasible=torch.ones(S, dtype=torch.bool),
                     nodes_solved=torch.ones(S, dtype=torch.int32))


def run_serve_storm(seed: int, tmp_path) -> dict:
    """One seeded storm round.  Healthy tenants acme/zeta run mixed
    sessions; mallory hangs+poisons+floods; ghost gets its connection
    dropped mid-run; a preemption fires mid-traffic; and a concurrent
    dispatch storm (with an injected dispatcher-thread death) hammers
    the process-default scheduler the whole time."""
    rng = np.random.default_rng(seed)
    hang_ord = int(rng.integers(0, 2))
    plan = FaultPlan(seed=seed, serves=(
        ServeFault("hang", tenant="mallory", at_sessions=(hang_ord,),
                   hang_s=20.0),
        ServeFault("poison", tenant="mallory",
                   at_sessions=(1 - hang_ord,)),
        ServeFault("disconnect", tenant="ghost", at_sessions=(0,)),
        ServeFault("flood", tenant="mallory", flood_factor=2),
    ), dispatches=(
        DispatchFault("kill_dispatcher"),
        DispatchFault("slow", jitter_s=0.004),
    ))
    engine = SyntheticEngine(
        iters=5, step_s=0.004,
        preempt_at={("acme", int(rng.integers(0, 2))): 2})
    srv = WheelServer(ServeOptions(
        unix_path=str(tmp_path / f"storm{seed}.sock"),
        trace_dir=str(tmp_path / f"traces{seed}"),
        max_running=2, max_queued=8, max_queued_per_tenant=4,
        default_deadline_s=3.0, engine=engine, fault_plan=plan,
        multiplex=False, device="cpu")).start()

    # the concurrent dispatch storm: its own scheduler armed with the
    # SAME plan (kill_dispatcher fires in its daemon); tickets must
    # resolve typed while serve traffic flows
    sched = SolveScheduler(
        DispatchOptions(max_wait_ms=2.0, dispatch_timeout_s=0.25,
                        retry_max=1, retry_backoff_s=0.005,
                        deadline_s=3.0),
        solve_fn=_fake_solve, fault_plan=plan)
    base = convert.boxqp_from_arrays(
        convert.arrays_of(random_mips(S=2, n=6, m=4)[0]), "cpu")
    d = torch.ones(6)
    ic = np.arange(2, dtype=np.int64)
    storm_out: dict = {}

    def dispatch_storm():
        tickets = [sched.submit(dataclasses.replace(
            base, c=base.c * (k + 1)), d, ic) for k in range(6)]
        for k, t in enumerate(tickets):
            try:
                storm_out[k] = t.result(timeout=8.0).inner.numpy()
            except SolveFailed as e:
                storm_out[k] = e

    records: list = []
    rec_lock = threading.Lock()

    def healthy(tenant, ci):
        cl = loadgen.ServeClient(srv.address, timeout=30.0)
        try:
            for k in range(2):
                rec = loadgen.run_session(cl, SubmitRequest(
                    tenant=tenant, model="farmer", num_scens=3,
                    sla="latency" if k == 0 else "throughput",
                    deadline_s=10.0))
                with rec_lock:
                    records.append(rec)
        finally:
            cl.close()

    def mallory():
        cl = loadgen.ServeClient(srv.address, timeout=30.0)
        try:
            n = 2 * plan.serve_flood_factor("mallory")
            for k in range(n):
                rec = loadgen.run_session(
                    cl, SubmitRequest(tenant="mallory",
                                      model="farmer", num_scens=3,
                                      deadline_s=4.0))
                with rec_lock:
                    records.append(rec)
        finally:
            cl.close()

    ghost_server_done = threading.Event()

    def ghost():
        cl = loadgen.ServeClient(srv.address, timeout=6.0)
        try:
            rec = loadgen.run_session(cl, SubmitRequest(
                tenant="ghost", model="farmer", num_scens=3,
                deadline_s=10.0))
            with rec_lock:
                records.append(rec)
        except (socket.timeout, ConnectionError, OSError):
            # the dropped connection: the CLIENT may never see the
            # terminal line — the server-side invariant (terminal
            # state + freed quota) is asserted below
            ghost_server_done.set()
        finally:
            cl.close()

    threads = [threading.Thread(target=healthy, args=("acme", 0)),
               threading.Thread(target=healthy, args=("zeta", 1)),
               threading.Thread(target=mallory),
               threading.Thread(target=ghost),
               threading.Thread(target=dispatch_storm)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    wall = time.perf_counter() - t0
    alive = [t.name for t in threads if t.is_alive()]
    # settle server-side terminal accounting before the asserts
    deadline = time.perf_counter() + 15.0
    while time.perf_counter() < deadline:
        states = srv.stats()["states"]
        nonterminal = sum(v for k, v in states.items()
                          if k not in ("DONE", "FAILED", "REJECTED"))
        if nonterminal == 0:
            break
        time.sleep(0.05)
    stats = srv.stats()
    sessions = dict(srv._sessions)
    srv.stop()
    sched.close()
    return {"seed": seed, "plan": plan, "records": records,
            "storm_out": storm_out, "stats": stats, "wall": wall,
            "alive": alive, "sessions": sessions}


def assert_storm_invariants(r: dict) -> None:
    assert not r["alive"], \
        f"DEADLOCK: {r['alive']} still alive (seed {r['seed']})"
    # every client-side record reached a terminal outcome
    for rec in r["records"]:
        assert rec["outcome"] in ("done", "failed", "rejected"), rec
    # the healthy tenants' non-rejected sessions all finished; a
    # preempted one resumed to done (no client-visible loss)
    healthy = [rec for rec in r["records"]
               if rec["tenant"] in ("acme", "zeta")]
    assert healthy
    for rec in healthy:
        assert rec["outcome"] in ("done", "rejected"), rec
    assert any(rec.get("preempted") for rec in healthy), \
        "the mid-traffic preemption never exercised"
    # mallory's hang resolved at its deadline, typed; the poison is a
    # typed failure; floods are typed rejects or served — never a hang
    mall = [rec for rec in r["records"] if rec["tenant"] == "mallory"]
    reasons = {rec.get("reason") for rec in mall
               if rec["outcome"] == "failed"}
    assert "deadline" in reasons or "RuntimeError" in reasons, mall
    # EVERY server-side session is terminal and quotas fully restored
    for s in r["sessions"].values():
        assert s.state in ("DONE", "FAILED", "REJECTED"), \
            (s.sid, s.tenant, s.state)
    for name, t in r["stats"]["admission"]["tenants"].items():
        assert t["inflight"] == 0, (name, t)
    # the dispatch storm's tickets all resolved (result or typed)
    assert set(r["storm_out"]) == set(range(6))
    for k, out in r["storm_out"].items():
        if isinstance(out, SolveFailed):
            assert out.reason in ("timeout", "exception", "deadline",
                                  "dispatcher-died")
    # the seams actually fired
    seams = {s for s, _ in r["plan"].fired}
    assert "serve" in seams and "dispatch" in seams
    assert r["wall"] < 60.0


def test_serve_chaos_storm_fast_seeded(tmp_path):
    """Tier-1 subset: two seeded storms."""
    for seed in (11, 23):
        assert_storm_invariants(run_serve_storm(seed, tmp_path))


@pytest.mark.slow
def test_serve_chaos_storm_soak(tmp_path):
    """The long soak across the fault-mix space."""
    for seed in range(400, 412):
        assert_storm_invariants(run_serve_storm(seed, tmp_path))
