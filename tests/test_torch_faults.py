# Port of the fault plan's wheel and dispatch seams (resilience/faults.py,
# cylinders/hub.py, dispatch/scheduler.py) on the CPU:
#   * the harvest seam: NaN bounds are rejected and struck, and the spoke
#     is disabled after spoke_max_strikes; a wrong-sense bound is rejected
#     without a strike;
#   * the lane seam: corrupted PDHG lanes (scaled or NaN) are caught by
#     the lane guard (ops/pdhg._lane_guard) and the wheel still
#     certifies;
#   * the scheduler seams: the seeded chaos rounds of
#     tests/test_dispatch_chaos.py (poison, dropped ticket, hang or
#     exception, slow device) quarantine exactly the poisoned submits and
#     give every healthy submit its own lanes; a dropped ticket resolves
#     by its deadline; a killed dispatcher fails queued tickets once; the
#     hub arms its run's plan on the process-default scheduler, whose
#     quarantines land on the bus and in the metrics registry; a
#     dispatch storm beside a wheel leaves the wheel's bounds unchanged.
# The cases of tests/test_dispatch_chaos.py that need a checkpoint or a
# preemption wait for the checkpoint slice.
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch import dispatch
from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.algos import fused_wheel as fw
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.cylinders import spoke as sm
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.dispatch import (
    DispatchOptions, SolveFailed, SolveScheduler,
)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.ops.bnb import BnBResult
from mpisppy_tpu_torch.resilience import (
    DispatchFault, FaultPlan, LaneFault, SpokeBoundFault,
)
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.telemetry import metrics

from test_mip_bnb import random_mips

torch.set_num_threads(1)

FARMER_EF_OBJ = -108390.0


@pytest.fixture(scope="module")
def batch():
    return batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3)
         for nm in farmer.scenario_names_creator(3)], device="cpu")


def farmer_wheel(batch, hub_extra=None, max_iterations=40, guard=False,
                 rel_gap=1e-2):
    """The port's farmer fused wheel (Lagrangian + x̂-x̄ + slam), its
    events collected from a private bus."""
    seen = []

    class Probe:
        def handle(self, e):
            seen.append(e)

        def close(self):
            pass

    bus = tel.EventBus()
    bus.subscribe(Probe())
    popts = pdhg.PDHGOptions(tol=1e-7, lane_guard=guard)
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": rel_gap,
                                      "telemetry_bus": bus,
                                      **(hub_extra or {})}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {
               "options": ph_mod.PHOptions(
                   default_rho=1.0, max_iterations=max_iterations,
                   conv_thresh=0.0, subproblem_windows=10, pdhg=popts),
               "batch": batch,
               "wheel_options": fw.FusedWheelOptions(
                   slam_windows=2, slam_sense_max=False)}}
    spokes = [{"spoke_class": c, "opt_kwargs": {"options": {}}}
              for c in (sm.FusedLagrangianOuterBound,
                        sm.FusedXhatXbarInnerBound, sm.FusedSlamHeuristic)]
    return WheelSpinner(hub, spokes).spin(), seen


def kinds(seen, kind):
    return [e for e in seen if e.kind == kind]


def test_nan_bound_is_struck_then_the_spoke_disabled(batch):
    plan = FaultPlan(spoke_bounds=(SpokeBoundFault("nan", spoke_index=0),))
    ws, seen = farmer_wheel(batch, {"fault_plan": plan,
                                    "spoke_max_strikes": 3},
                            max_iterations=8)
    lag = ws.spcomm.spokes[0]
    assert lag.disabled and lag.strikes == 3
    strikes = kinds(seen, tel.SPOKE_STRIKE)
    assert [e.data["strikes"] for e in strikes] == [1, 2, 3]
    assert all("non-finite" in e.data["reason"] for e in strikes)
    assert [e.data["spoke"] for e in kinds(seen, tel.SPOKE_DISABLE)] == [0]
    # a disabled spoke is never harvested again: three injections only
    assert len([s for s, _ in plan.fired if s == "spoke_bound"]) == 3
    assert not any(e.data["spoke"] == 0
                   for e in kinds(seen, tel.BOUND_ACCEPT))
    assert np.isfinite(ws.BestInnerBound)


def test_wrong_sense_bound_is_rejected_without_a_strike(batch):
    plan = FaultPlan(spoke_bounds=(
        SpokeBoundFault("wrong_sense", spoke_index=1, at_iters=(6,)),))
    ws, seen = farmer_wheel(batch, {"fault_plan": plan})
    rej = kinds(seen, tel.BOUND_REJECT)
    assert [(e.hub_iter, e.data["spoke"]) for e in rej] == [(6, 1)]
    assert rej[0].data["reason"].startswith("sense-violating")
    assert not kinds(seen, tel.SPOKE_STRIKE)
    assert getattr(ws.spcomm.spokes[1], "strikes", 0) == 0
    assert not getattr(ws.spcomm.spokes[1], "disabled", False)
    assert ws.BestOuterBound <= FARMER_EF_OBJ <= ws.BestInnerBound


@pytest.mark.parametrize("mode", ["scale", "nan"])
def test_lane_fault_is_caught_by_the_lane_guard(batch, mode):
    plan = FaultPlan(lanes=(LaneFault(at_iter=4, lanes=(1,), mode=mode),))
    ws, seen = farmer_wheel(batch, {"fault_plan": plan}, guard=True)
    assert plan.fired == [("lanes", f"{mode} lanes(1,) iter4")]
    assert [e.hub_iter for e in kinds(seen, tel.FAULT_INJECTED)] == [4]
    resets = ws.opt.state.solver.guard_resets
    assert int(resets[1]) >= 1 and int(resets[0]) == int(resets[2]) == 0
    assert np.isfinite(ws.opt.state.solver.x.numpy()).all()
    _, rel_gap = ws.spcomm.compute_gaps()
    assert rel_gap <= 1e-2
    assert ws.BestOuterBound <= FARMER_EF_OBJ <= ws.BestInnerBound


# -- the scheduler seams ----------------------------------------------------
def _fake_result(qp):
    S = qp.c.shape[0]
    inner = qp.c.sum(dim=-1)                 # request-identifying value
    return BnBResult(x=torch.zeros_like(qp.c), inner=inner,
                     outer=inner - 1.0, gap=torch.zeros(S),
                     feasible=torch.ones(S, dtype=torch.bool),
                     nodes_solved=torch.ones(S, dtype=torch.int32))


def _fake_solve(qp, d_col, int_cols, opts, **kw):
    time.sleep(0.002)                        # a tiny "device" latency
    return _fake_result(qp)


@pytest.fixture(scope="module")
def base_qp():
    return convert.boxqp_from_arrays(
        convert.arrays_of(random_mips(S=2, n=6, m=4)[0]), "cpu")


def run_soak_round(base, seed, n_submitters=8, submits_each=2):
    """tests/test_dispatch_chaos.py's seeded round: a threaded storm of
    submits against a scheduler armed with a randomized dispatch plan."""
    rng = np.random.default_rng(seed)
    total = n_submitters * submits_each
    poison = tuple(int(s) for s in rng.choice(
        total, size=rng.integers(1, 3), replace=False))
    droppable = sorted(set(range(total)) - set(poison))
    drop = (int(rng.choice(droppable)),)
    burst_kind = "hang" if rng.random() < 0.5 else "exception"
    plan = FaultPlan(seed=seed, dispatches=(
        DispatchFault("poison", submits=poison),
        DispatchFault("drop_ticket", submits=drop),
        DispatchFault(burst_kind, at_dispatches=(int(rng.integers(0, 3)),),
                      hang_s=30.0),
        DispatchFault("slow", jitter_s=0.005),
    ))
    sched = SolveScheduler(
        DispatchOptions(max_wait_ms=2.0, max_inflight=2,
                        dispatch_timeout_s=0.25, retry_max=1,
                        retry_backoff_s=0.005, deadline_s=2.0),
        solve_fn=_fake_solve, fault_plan=plan)
    d = torch.ones(base.c.shape[-1])
    ic = np.arange(2, dtype=np.int64)
    cs = [rng.standard_normal((2, 6)).astype(np.float32)
          for _ in range(total)]
    outcomes, expected = {}, {}
    lock = threading.Lock()

    def submitter(tid):
        for j in range(submits_each):
            k = tid * submits_each + j
            qp = dataclasses.replace(base, c=torch.as_tensor(cs[k]))
            t = sched.submit(qp, d, ic)
            with lock:
                expected[t.sid] = cs[k]
            try:
                res = t.result(timeout=10.0)
                with lock:
                    outcomes[t.sid] = res.inner.numpy()
            except SolveFailed as e:
                with lock:
                    outcomes[t.sid] = e

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(n_submitters)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "DEADLOCK"
    sched.close()
    return plan, sched, expected, set(poison), set(drop), outcomes, total, \
        wall


@pytest.mark.parametrize("seed", [101, 202])
def test_chaos_round_quarantines_exactly_the_poisoned_submits(base_qp,
                                                              seed):
    plan, sched, expected, poison, drop, outcomes, total, wall = \
        run_soak_round(base_qp, seed)
    assert set(outcomes) == set(range(total))     # every ticket resolved
    for sid, out in outcomes.items():
        if sid in poison:
            assert isinstance(out, SolveFailed)
            assert out.reason in ("exception", "timeout", "deadline")
        elif sid in drop:
            assert isinstance(out, SolveFailed) and out.reason == "deadline"
        elif isinstance(out, SolveFailed):
            assert out.reason in ("timeout", "exception", "deadline",
                                  "dispatcher-died")
        else:                                     # its OWN lanes back
            assert np.allclose(out, expected[sid].sum(-1), atol=1e-4)
    resolved_q = sum(2 for sid in poison
                     if isinstance(outcomes[sid], SolveFailed)
                     and outcomes[sid].reason in ("exception", "timeout"))
    assert sched.stats()["quarantined_lanes"] >= resolved_q
    assert "dispatch" in {s for s, _ in plan.fired}
    assert wall < 45.0


def test_dropped_ticket_resolves_by_its_deadline(base_qp):
    plan = FaultPlan(dispatches=(DispatchFault("drop_ticket", submits=(0,)),))
    sched = SolveScheduler(DispatchOptions(max_wait_ms=1.0),
                           solve_fn=_fake_solve, fault_plan=plan)
    d = torch.ones(base_qp.c.shape[-1])
    ic = np.arange(2, dtype=np.int64)
    t0 = sched.submit(base_qp, d, ic, deadline_s=0.5)
    t1 = sched.submit(base_qp, d, ic, deadline_s=5.0)
    with pytest.raises(SolveFailed) as ei:
        t0.result()
    assert ei.value.reason == "deadline"
    assert np.allclose(t1.result().inner.numpy(),
                       base_qp.c.sum(-1).numpy())
    assert plan.fired == [("dispatch", "drop_ticket submit0")]
    sched.close()


def test_killed_dispatcher_fails_queued_tickets_once(base_qp):
    plan = FaultPlan(dispatches=(DispatchFault("kill_dispatcher"),))
    sched = SolveScheduler(DispatchOptions(max_wait_ms=50.0),
                           solve_fn=_fake_solve, fault_plan=plan)
    d = torch.ones(base_qp.c.shape[-1])
    ic = np.arange(2, dtype=np.int64)
    before = metrics.REGISTRY.get("dispatch_dispatcher_deaths_total")
    t = sched.submit(base_qp, d, ic, deadline_s=5.0)
    with pytest.raises(SolveFailed) as ei:
        t.result()
    assert ei.value.reason == "dispatcher-died"
    t2 = sched.submit(base_qp, d, ic)            # the daemon restarts
    assert t2.result().inner.shape == (2,)
    assert plan.fired == [("dispatch", "kill_dispatcher")]
    assert sched.stats()["dispatcher_deaths"] == 1
    assert metrics.REGISTRY.get("dispatch_dispatcher_deaths_total") \
        == before + 1
    sched.close()


def test_hub_arms_the_run_plan_on_the_scheduler(batch, base_qp):
    """A hub with a fault plan arms it on the process-default scheduler
    (which adopts the hub's run id); a poisoned submit is quarantined,
    with a dispatch-quarantine event on the bus and the registry's
    quarantine counters moved."""
    plan = FaultPlan(dispatches=(DispatchFault("poison", submits=(0,)),))
    bus = tel.EventBus()
    seen = []

    class Probe:
        def handle(self, e):
            seen.append(e)

        def close(self):
            pass

    bus.subscribe(Probe())
    sched = dispatch.configure(
        DispatchOptions(max_wait_ms=1.0, retry_max=0), bus=bus)
    try:
        sched.solve_fn = _fake_solve
        ws = WheelSpinner({
            "hub_class": PHHub,
            "hub_kwargs": {"options": {"fault_plan": plan,
                                       "telemetry_bus": bus}},
            "opt_class": fw.FusedPH,
            "opt_kwargs": {"options": ph_mod.PHOptions(), "batch": batch},
        }, []).build()
        assert sched.fault_plan is plan and sched.run == ws.spcomm.run_id
        before = metrics.REGISTRY.get("dispatch_quarantined_requests_total")
        d = torch.ones(base_qp.c.shape[-1])
        ic = np.arange(2, dtype=np.int64)
        with pytest.raises(SolveFailed):
            sched.submit(base_qp, d, ic).result()
        assert sched.submit(base_qp, d, ic).result().inner.shape == (2,)
    finally:
        dispatch.configure()
    q = [e for e in seen if e.kind == tel.DISPATCH_QUARANTINE]
    assert [(e.run, e.data["submit"]) for e in q] == [(ws.spcomm.run_id, 0)]
    assert [e.data["requests"] for e in seen
            if e.kind == tel.DISPATCH] == [1]
    assert metrics.REGISTRY.get("dispatch_quarantined_requests_total") \
        == before + 1


def test_wheel_bounds_survive_a_dispatch_storm(batch, base_qp):
    """A hung-dispatch + poison storm against the process-default
    scheduler while the wheel spins: every storm ticket resolves (the
    poisoned one typed), and the wheel's bounds equal the fault-free
    run's exactly."""
    ws0, _ = farmer_wheel(batch)
    plan = FaultPlan(seed=7, dispatches=(
        DispatchFault("poison", submits=(1,)),
        DispatchFault("hang", at_dispatches=(0,), hang_s=30.0)))
    sched = dispatch.configure(DispatchOptions(
        max_wait_ms=2.0, dispatch_timeout_s=0.2, retry_max=1,
        retry_backoff_s=0.005, deadline_s=10.0))
    sched.solve_fn = _fake_solve
    sched.fault_plan = plan
    d = torch.ones(base_qp.c.shape[-1])
    ic = np.arange(2, dtype=np.int64)
    out = {}

    def storm():
        tickets = [sched.submit(dataclasses.replace(
            base_qp, c=base_qp.c * (k + 1)), d, ic) for k in range(4)]
        for k, t in enumerate(tickets):
            try:
                out[k] = t.result(timeout=10.0).inner.numpy()
            except SolveFailed as e:
                out[k] = e

    th = threading.Thread(target=storm)
    try:
        th.start()
        ws1, _ = farmer_wheel(batch, {"fault_plan": plan})
        th.join(timeout=30.0)
        assert not th.is_alive(), "the storm deadlocked"
    finally:
        dispatch.configure()
    assert sched.fault_plan is plan
    assert set(out) == {0, 1, 2, 3} and isinstance(out[1], SolveFailed)
    for k in (0, 2, 3):
        if not isinstance(out[k], SolveFailed):
            assert np.allclose(out[k], (base_qp.c * (k + 1)).sum(-1)
                               .numpy(), atol=1e-4)
    assert (ws1.BestOuterBound, ws1.BestInnerBound) == \
        (ws0.BestOuterBound, ws0.BestInnerBound)
