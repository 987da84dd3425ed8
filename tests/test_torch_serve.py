# Port parity: the multi-tenant wheel server (mpisppy_tpu_torch/serve/)
# against the JAX package's (mpisppy_tpu/serve/) on the CPU:
#   * session_argv is the JAX one with the port's model module, then the
#     server's --device after the client's args;
#   * FairQueue pops the JAX order for one seeded sequence of submits,
#     weights, quotas, SLA classes, releases and per-step charges;
#   * StructureInterner.digests() equals the JAX interner's for the same
#     arrays, and a batch interns its shared fields only;
#   * cross-session coalescing through the port's scheduler: one
#     megabatch of 4 lanes, each lane its solo result, both sessions'
#     run ids in the breakdown; without interning, none coalesce;
#   * a farmer S=3 session over a unix socket, driven by the JAX
#     package's client: the port CLI's bounds on the same argv exactly,
#     the JAX WheelEngine's within 2e-3 (the farmer wheel tolerance of
#     tests/test_torch_wheel.py);
#   * typed rejection, disconnect, deadline, bad args and the status op,
#     and a preempt-and-resume round trip equal to the uninterrupted run.
import contextlib
import dataclasses
import io
import json
import threading
import time

import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu.serve import admission as jadm
from mpisppy_tpu.serve import engine as jeng
from mpisppy_tpu.serve import loadgen as jloadgen
from mpisppy_tpu.serve import multiplex as jmux
from mpisppy_tpu.serve import protocol as jproto
from mpisppy_tpu.serve import session as jsess
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch import dispatch
from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.dispatch import DispatchOptions, SolveScheduler
from mpisppy_tpu_torch.ops.bnb import BnBResult
from mpisppy_tpu_torch.resilience import FaultPlan, ServeFault
from mpisppy_tpu_torch.serve import (
    MODELS, AdmissionRejected, FairQueue, ServeOptions, SubmitRequest,
    WheelServer,
)
from mpisppy_tpu_torch.serve import loadgen, multiplex
from mpisppy_tpu_torch.serve.engine import (
    SyntheticEngine, WheelEngine, session_argv,
)
from mpisppy_tpu_torch.serve.session import Session

from test_mip_bnb import random_mips

torch.set_num_threads(1)

FARMER_REL = 2e-3


def _spec(tenant="acme", sla="throughput", **kw):
    kw.setdefault("model", "farmer")
    kw.setdefault("num_scens", 3)
    return SubmitRequest(tenant=tenant, sla=sla, **kw)


def _jax_name(argv):
    return [a.replace("mpisppy_tpu_torch.", "mpisppy_tpu.") for a in argv]


# ---------------------------------------------------------------------------
# protocol and argv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multiplexed", [False, True])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_session_argv_matches_jax(model, multiplexed):
    """The JAX argv with the port's model module, then --device after the
    client's args (so the last --device, the server's, wins)."""
    d = dict(tenant="t", model=model, num_scens=5, gap_target=0.02,
             max_iterations=33, args=["--device", "cpu", "--rel-gap",
                                      "0.03"])
    t = session_argv(SubmitRequest.from_dict(d), multiplexed, "cuda")
    j = jeng.session_argv(jproto.SubmitRequest.from_dict(d), multiplexed)
    assert t[-2:] == ["--device", "cuda"]
    assert _jax_name(t[:-2]) == j
    assert MODELS[model] == jproto.MODELS[model].replace(
        "mpisppy_tpu.", "mpisppy_tpu_torch.")


def test_wire_format_is_the_jax_one():
    """The same submit dict round-trips to the same wire bytes."""
    d = dict(tenant="acme", sla="latency", model="uc", num_scens=4,
             gap_target=0.05, deadline_s=9.0, max_iterations=12,
             args=["--uc-n-gens", "2"], mpc_steps=3, step_deadline_s=2.0,
             traceparent="00-" + "a" * 32 + "-" + "b" * 16 + "-01")
    t = SubmitRequest.from_dict(d).to_dict()
    j = jproto.SubmitRequest.from_dict(d).to_dict()
    assert t == j
    from mpisppy_tpu_torch.serve import protocol
    ev = {"event": "progress", "outer": float("nan"), "iter": 3}
    assert protocol.encode(ev) == jproto.encode(ev)
    for bad in ({"tenant": ""}, {"tenant": "a", "sla": "gold"},
                {"tenant": "a", "model": "x"},
                {"tenant": "a", "step_deadline_s": 1.0}):
        with pytest.raises(protocol.ProtocolError):
            SubmitRequest.from_dict(bad)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------
class _Sub:
    """The fields FairQueue reads, for either package's queue."""

    def __init__(self, tenant, sla):
        self.tenant, self.sla, self.ordinal = tenant, sla, -1
        self.dead = False

    def is_terminal(self):
        return self.dead


def _fair_queue_trace(queue_cls, seed):
    """One seeded run of submits, pops, releases, per-step charges and a
    reaped session: the popped (tenant, ordinal) sequence and the stats."""
    rng = np.random.default_rng(seed)
    q = queue_cls(max_queued=40, max_queued_per_tenant=12,
                  default_quota=2, latency_burst=2,
                  weights={"big": 3.0, "mid": 1.5},
                  quotas={"mid": 1, "small": 3})
    tenants = ("big", "mid", "small", "tiny")
    out, running = [], []
    for step in range(120):
        r = rng.random()
        if r < 0.45:
            s = _Sub(tenants[rng.integers(4)],
                     "latency" if rng.random() < 0.3 else "throughput")
            try:
                q.submit(s)
            except Exception as e:       # the package's AdmissionRejected
                out.append(("rejected", e.reason))
            if rng.random() < 0.05:
                s.dead = True            # reaped while queued
        elif r < 0.75:
            s = q.pop()
            out.append(None if s is None else (s.tenant, s.ordinal))
            if s is not None:
                running.append(s)
        elif r < 0.9 and running:
            q.release(running.pop(int(rng.integers(len(running)))))
        elif running:
            q.charge_step(running[int(rng.integers(len(running)))])
    return out, q.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_queue_pops_the_jax_order(seed):
    t, ts = _fair_queue_trace(FairQueue, seed)
    j, js = _fair_queue_trace(jadm.FairQueue, seed)
    assert t == j
    assert ts == js
    assert any(x is not None and x[0] != "rejected" for x in t)


def test_backpressure_is_typed_and_quota_defers():
    q = FairQueue(max_queued=2, max_queued_per_tenant=2, default_quota=1)
    a, b = _Sub("A", "throughput"), _Sub("A", "throughput")
    q.submit(a)
    q.submit(b)
    with pytest.raises(AdmissionRejected) as ei:
        q.submit(_Sub("A", "throughput"))
    assert ei.value.reason in ("queue-full", "tenant-queue-full")
    assert q.pop() is a and q.pop() is None     # A at quota
    q.release(a)
    assert q.pop() is b
    q.drain()
    with pytest.raises(AdmissionRejected) as ei:
        q.submit(_Sub("B", "latency"))
    assert ei.value.reason == "draining"


# ---------------------------------------------------------------------------
# structure interning
# ---------------------------------------------------------------------------
def test_interner_digests_match_jax():
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((6, 9)).astype(np.float32),
              rng.standard_normal(9).astype(np.float32),
              np.arange(12, dtype=np.int64).reshape(3, 4),
              (rng.random(5) < 0.5)]
    t_it, j_it = multiplex.StructureInterner(), jmux.StructureInterner()
    for a in arrays:
        t_it.intern(torch.as_tensor(a))
        j_it.intern(jnp.asarray(a) if a.dtype != np.int64 else a)
    assert t_it.digests() == j_it.digests()
    # an equal tensor interns to the first; a CPU tensor and a numpy
    # array of the same bytes live under different devices
    first = torch.as_tensor(arrays[0])
    it = multiplex.StructureInterner(max_entries=4)
    assert it.intern(first) is first
    assert it.intern(first.clone()) is first
    assert it.intern(arrays[0]) is not first
    for k in range(10):
        it.intern(torch.full((3,), float(k)))
    st = it.stats()
    assert st["entries"] <= 4 and st["evictions"] >= 6 and st["hits"] == 1


def test_intern_batch_interns_only_shared_fields():
    """A batch's shared (unbatched) fields intern; its per-scenario fields
    pass through untouched, so the cost is one hash per shared field."""
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import sslp
    inst = sslp.synthetic_instance(3, 6, seed=0)

    def build():
        specs = [sslp.scenario_creator(nm, instance=inst, num_scens=4,
                                       lp_relax=True)
                 for nm in sslp.scenario_names_creator(4)]
        return batch_mod.from_specs(specs, device="cpu")

    it = multiplex.StructureInterner()
    b1 = multiplex.intern_batch(build(), it)
    raw = build()
    b2 = multiplex.intern_batch(raw, it)
    assert b2.qp.A is b1.qp.A and b2.qp.A.ndim == 2
    shared = [f for f in ("c", "q", "bl", "bu", "l", "u")
              if getattr(raw.qp, f).ndim == 1]
    batched = [f for f in ("c", "q", "bl", "bu", "l", "u")
               if getattr(raw.qp, f).ndim == 2]
    for f in shared:
        assert getattr(b2.qp, f) is getattr(b1.qp, f)
    for f in batched:
        assert getattr(b2.qp, f) is getattr(raw.qp, f)
    st = it.stats()
    n_shared = 1 + len(shared) + (raw.d_col.ndim == 1)
    assert st["misses"] == n_shared and st["hits"] == n_shared


# ---------------------------------------------------------------------------
# cross-session coalescing == per-session results
# ---------------------------------------------------------------------------
def _fake_solve(qp, d_col, int_cols, opts, **kw):
    time.sleep(0.002)
    S = qp.c.shape[0]
    inner = qp.c.sum(dim=-1)
    return BnBResult(x=torch.zeros_like(qp.c), inner=inner,
                     outer=inner - 1.0, gap=torch.zeros(S),
                     feasible=torch.ones(S, dtype=torch.bool),
                     nodes_solved=torch.ones(S, dtype=torch.int32))


@pytest.fixture(scope="module")
def base_qp():
    return convert.boxqp_from_arrays(
        convert.arrays_of(random_mips(S=2, n=6, m=4)[0]), "cpu")


def test_cross_session_coalescing_matches_per_session_results(base_qp):
    """tests/test_serve.py's case on the port's scheduler: two sessions
    build equal-but-distinct shared A; interned, their concurrent
    submits (each thread with its own session token) coalesce into one
    4-lane megabatch, each lane its solo result, the breakdown naming
    both runs; without interning they make two dispatches."""
    A_shared = base_qp.A[0].clone()
    interner = multiplex.StructureInterner()

    def session_qp(seed):
        rng = np.random.default_rng(seed)
        qp = dataclasses.replace(
            base_qp, A=A_shared.clone(),
            c=torch.as_tensor(rng.standard_normal((2, 6))
                              .astype(np.float32)))
        return multiplex.intern_qp(qp, interner=interner)

    qps = [session_qp(1), session_qp(2)]
    assert qps[0].A is qps[1].A
    assert interner.stats()["hits"] >= 1
    rows = []

    class _Capture:
        def handle(self, event):
            rows.append(json.loads(event.to_json()))

        def close(self):
            pass

    bus = tel.EventBus()
    bus.subscribe(_Capture())
    d, ic = torch.ones(6), np.arange(2, dtype=np.int64)
    sched = SolveScheduler(DispatchOptions(max_wait_ms=200.0, coalesce=True),
                           solve_fn=_fake_solve, bus=bus, run="sched")
    results, barrier = {}, threading.Barrier(2)

    def worker(i):
        # both submit before either blocks: result() dispatches its
        # window at once
        dispatch.set_session_context(f"run{i}", 3 + i)
        try:
            ticket = sched.submit(qps[i], d, ic)
            barrier.wait(timeout=10)
            results[i] = ticket.result(timeout=10)
        finally:
            dispatch.clear_session_context()

    th = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in th)
    st = sched.stats()
    sched.close()
    assert st["batches"] == 1 and st["coalesced_lanes"] == 4
    (row,) = st["by_key"].values()
    assert row["lanes"] == 4 and row["coalesced_lanes"] == 4
    for i in range(2):
        torch.testing.assert_close(results[i].inner, qps[i].c.sum(-1),
                                   rtol=0, atol=1e-5)
    (ev,) = [r for r in rows if r["kind"] == "dispatch"]
    assert {s["run"]: s["iter"] for s in ev["data"]["sessions"]} \
        == {"run0": 3, "run1": 4}

    sched2 = SolveScheduler(DispatchOptions(max_wait_ms=30.0, coalesce=True),
                            solve_fn=_fake_solve)
    qa = dataclasses.replace(base_qp, A=A_shared.clone())
    qb = dataclasses.replace(base_qp, A=A_shared.clone())
    ta, tb = sched2.submit(qa, d, ic), sched2.submit(qb, d, ic)
    ta.result(), tb.result()
    assert sched2.stats()["batches"] == 2
    sched2.close()


# ---------------------------------------------------------------------------
# the server end to end
# ---------------------------------------------------------------------------
def _start_server(tmp_path, engine=None, **opt_kw):
    opt_kw.setdefault("unix_path", str(tmp_path / "wheel.sock"))
    opt_kw.setdefault("trace_dir", str(tmp_path / "traces"))
    opt_kw.setdefault("spool_dir", str(tmp_path / "spool"))
    opt_kw.setdefault("max_running", 2)
    opt_kw.setdefault("device", "cpu")
    if engine is not None:
        opt_kw.setdefault("multiplex", False)
        opt_kw["engine"] = engine
    return WheelServer(ServeOptions(**opt_kw)).start()


def _cli_line(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(args)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_farmer_session_over_the_socket_matches_cli_and_jax(tmp_path):
    """A farmer S=3 session served over a unix socket and driven by the
    JAX package's client: progress lines then done; the done bounds are
    the port CLI's on the session argv exactly, and the JAX engine's on
    the same spec within FARMER_REL; the session trace analyzes."""
    from mpisppy_tpu_torch import generic_cylinders as tgc
    from mpisppy_tpu_torch.telemetry import analyze as an
    spec = _spec(tenant="acme", gap_target=0.01, max_iterations=150)
    srv = _start_server(tmp_path, multiplex=True)
    try:
        cl = jloadgen.ServeClient(srv.address, timeout=240.0)
        rec = jloadgen.run_session(cl, jproto.SubmitRequest.from_dict(
            spec.to_dict()))
        cl.close()
        stats = srv.stats()
    finally:
        srv.stop()
    assert rec["outcome"] == "done", rec
    assert rec["time_to_gap_s"] is not None
    sess = list(srv._sessions.values())[0]
    done = sess.outcome
    assert done["rel_gap"] <= 0.01 + 1e-9
    assert stats["exchange_ring"]["grants"] >= done["iterations"] - 1
    cli = _cli_line(tgc.main, session_argv(spec, True, "cpu"))
    assert (done["outer"], done["inner"], done["iterations"]) == (
        cli["outer_bound"], cli["inner_bound"], cli["iterations"])
    _, j = jeng.WheelEngine(multiplexed=True).run(jsess.Session(
        jproto.SubmitRequest.from_dict(spec.to_dict())))
    for f in ("outer", "inner"):
        assert abs(done[f] - j[f]) <= FARMER_REL * abs(j[f]), (f, done, j)
    trace = tmp_path / "traces" / f"session-{rec['session']}.jsonl"
    rep = an.analyze_path(str(trace))
    assert rep["bounds"]["final_rel_gap"] <= 0.01 + 1e-9
    kinds = {json.loads(ln)["kind"]
             for ln in trace.read_text().splitlines()}
    assert {"session-state", "hub-iteration", "exchange-overlap"} <= kinds


def test_typed_rejection_disconnect_and_status(tmp_path):
    """A flood is answered with typed rejects in the ack; a client that
    vanishes mid-run leaves its sessions to finish with the quota
    restored; the status op reports the replica's health."""
    eng = SyntheticEngine(iters=30, step_s=0.01)
    srv = _start_server(tmp_path, engine=eng, max_running=1,
                        max_queued=2, max_queued_per_tenant=2,
                        replica_id="r7")
    try:
        cl = loadgen.ServeClient(srv.address)
        acks = [cl.submit(_spec(tenant="flood")) for _ in range(6)]
        rejected = [a for a in acks if not a.get("ok")]
        accepted = [a for a in acks if a.get("ok")]
        assert rejected and accepted
        assert all(a["error"] == "rejected" and a["reason"] in
                   ("queue-full", "tenant-queue-full") for a in rejected)
        cl.send({"op": "status"})
        msg = cl.recv()
        while msg.get("event") is not None or "status" not in msg:
            msg = cl.recv()
        st = msg["status"]
        assert st["replica"] == "r7" and st["free_slots"] == 0
        assert st["running"] + st["queued"] == len(accepted)
        assert st["interner_digests"] == [] and st["draining"] is False
        cl.close()                              # disconnect mid-run
        deadline = time.time() + 30.0
        while time.time() < deadline:
            states = srv.stats()["states"]
            if states.get("DONE", 0) >= len(accepted):
                break
            time.sleep(0.05)
        assert srv.stats()["states"].get("DONE", 0) == len(accepted)
        assert srv.stats()["admission"]["tenants"]["flood"]["inflight"] == 0
    finally:
        srv.stop()


def test_deadline_and_bad_args_fail_typed(tmp_path):
    """A hanging session resolves at its deadline (failed, reason
    deadline); argparse-rejected session args fail typed (ValueError),
    never a hang."""
    plan = FaultPlan(seed=3, serves=(
        ServeFault("hang", tenant="acme", at_sessions=(0,), hang_s=60.0),))
    srv = _start_server(tmp_path, engine=SyntheticEngine(iters=3,
                                                         step_s=0.005),
                        fault_plan=plan)
    try:
        cl = loadgen.ServeClient(srv.address, timeout=30.0)
        rec = loadgen.run_session(cl, _spec(tenant="acme", deadline_s=1.0))
        cl.close()
    finally:
        srv.stop()
    assert (rec["outcome"], rec["reason"]) == ("failed", "deadline")
    assert ("serve", "hang acme#0") in plan.fired
    srv = _start_server(tmp_path / "b", multiplex=False, max_running=1)
    try:
        cl = loadgen.ServeClient(srv.address, timeout=60.0)
        rec = loadgen.run_session(cl, _spec(tenant="acme",
                                            args=("--no-such-flag",)))
        cl.close()
    finally:
        srv.stop()
    assert (rec["outcome"], rec["reason"]) == ("failed", "ValueError")


def test_preempt_mid_run_resumes_to_the_uninterrupted_bounds(tmp_path):
    """A preemption at hub iteration 4 saves the session, which re-enters
    the queue DEGRADED, restores from its spool checkpoint and finishes
    with the uninterrupted run's bounds and iterations (the port's
    resumed fused wheel follows the uninterrupted rows: ROADMAP C1)."""
    spec = _spec(tenant="acme", gap_target=0.01, max_iterations=150)
    _, base = WheelEngine(multiplexed=False, device="cpu").run(
        Session(_spec(tenant="truth", gap_target=0.01,
                      max_iterations=150)))
    plan = FaultPlan(seed=5, preempt_at_iter=4)
    srv = _start_server(tmp_path, multiplex=False, fault_plan=plan)
    try:
        cl = loadgen.ServeClient(srv.address, timeout=240.0)
        rec = loadgen.run_session(cl, spec)
        cl.close()
    finally:
        srv.stop()
    assert ("preemption", "iter4") in plan.fired
    assert rec["outcome"] == "done" and rec["preempted"] == 1, rec
    assert srv.stats()["preemptions"] == 1
    out = list(srv._sessions.values())[0].outcome
    assert (out["outer"], out["inner"], out["iterations"]) == (
        base["outer"], base["inner"], base["iterations"])
    kinds = [json.loads(ln)["kind"] for ln in (
        tmp_path / "traces" / f"session-{rec['session']}.jsonl")
        .read_text().splitlines()]
    assert "checkpoint-write" in kinds and "checkpoint-restore" in kinds
