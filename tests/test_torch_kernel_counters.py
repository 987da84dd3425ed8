# Port parity: the kernel counters (telemetry/counters.py, folded in by
# ops/pdhg._window at each restart boundary; harvested by the hub) — the
# mirror of tests/test_telemetry.py's counter tests and
# tests/test_async_wheel.py's harvest test:
#   * per-lane iters, restarts and omega_adapt equal the JAX package's
#     window by window on the same sslp 5x15 solve (S=16, from the JAX
#     initial state); a lane may differ only where its `done` flag
#     differed between the packages at a window boundary (ROADMAP.md C1),
#     and the test counts those lanes and bounds them;
#   * with counters off a state's counters are None and a window issues
#     the same torch ops as one whose options never named telemetry; on,
#     it issues more;
#   * totals accumulate across warm re-solves; the fused planes are
#     harvested under their own labels; the pipelined harvest never
#     undercounts; a lane fault emits lane-quarantine; the
#     kernel-counters event carries the JAX package's fields.
import dataclasses
from collections import Counter
from functools import partial

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.telemetry import counters as jcounters
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.algos import async_wheel as aw
from mpisppy_tpu_torch.algos import fused_wheel as fw
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.cylinders import spoke as spoke_mod
from mpisppy_tpu_torch.cylinders.hub import AsyncPHHub, PHHub
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.resilience.faults import FaultPlan, LaneFault
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.telemetry import counters as kcounters
from mpisppy_tpu_torch.telemetry import metrics
from mpisppy_tpu_torch.utils import cfg_vanilla

torch.set_num_threads(1)

SSLP_WINDOWS = 40      # restart windows of the per-lane comparison
MAX_DIVERGED = 2       # of 16 lanes whose done flags may part (C1)


@pytest.fixture(scope="module")
def farmer_batch():
    names = farmer.scenario_names_creator(3)
    return batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3) for nm in names],
        device="cpu")


def test_per_lane_counters_match_jax():
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    jb = jbatch.from_specs([
        jsslp.scenario_creator(nm, instance=inst, num_scens=16,
                               lp_relax=True)
        for nm in jsslp.scenario_names_creator(16)])
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    jopts = jpdhg.PDHGOptions(tol=1e-6, telemetry=True)
    topts = pdhg.PDHGOptions(tol=1e-6, telemetry=True)
    jst = jpdhg.init_state(jb.qp, jopts)
    tst = convert.pdhg_state_from_arrays(convert.arrays_of(jst), "cpu")
    assert tst.counters is not None and tst.counters.ring_pos == 0
    jwin = jax.jit(partial(jpdhg._window, opts=jopts))
    parted = np.zeros(16, bool)
    for _ in range(SSLP_WINDOWS):
        jst = jwin(jb.qp, jst)
        tst = pdhg._window(tb.qp, tst, topts)
        parted |= np.asarray(jst.done) != tst.done.numpy()
    want = {k: np.asarray(getattr(jst.counters, k))
            for k in ("iters", "restarts", "omega_adapt")}
    got = kcounters.per_lane(tst)
    differ = np.zeros(16, bool)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        differ |= got[k] != want[k]
    # every lane that differs parted at a window boundary, and few did
    assert not (differ & ~parted).any(), np.nonzero(differ & ~parted)
    assert parted.sum() <= MAX_DIVERGED
    assert want["iters"].max() > 0 and want["restarts"].sum() > 0
    assert tst.counters.ring_pos == int(jst.counters.ring_pos) \
        == SSLP_WINDOWS
    # the harvested totals follow the lanes
    th = kcounters.harvest_state(tst)
    jh = jcounters.harvest_state(jst)
    assert set(th) == set(jh)
    for k in ("pdhg_windows_total", "pdhg_guard_resets_total"):
        assert th[k] == jh[k]
    same = ~parted
    np.testing.assert_allclose(th["residual_ring"][same],
                               jh["residual_ring"][same], rtol=1e-3,
                               atol=1e-6)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _window_ops(qp, opts):
    st = pdhg.init_state(qp, opts)
    with _OpCount() as c:
        st = pdhg._window(qp, st, opts)
    return st, c.ops


def test_counters_off_is_none_and_issues_the_same_ops(farmer_batch):
    qp = farmer_batch.qp
    bare = pdhg.PDHGOptions(tol=1e-7)
    # the CLI's options with --kernel-counters off
    wired = cfg_vanilla._pdhg_opts({"pdhg_tol": 1e-7})
    assert wired == bare and not wired.telemetry
    st_bare, ops_bare = _window_ops(qp, bare)
    st_off, ops_off = _window_ops(qp, wired)
    assert st_bare.counters is None and st_off.counters is None
    assert ops_off == ops_bare
    st_on, ops_on = _window_ops(qp, dataclasses.replace(bare,
                                                        telemetry=True))
    assert st_on.counters is not None
    assert sum(ops_on.values()) > sum(ops_bare.values())
    # the counters change no iterate
    for f in ("x", "y", "omega", "score", "done"):
        assert torch.equal(getattr(st_on, f), getattr(st_bare, f)), f


def test_kernel_counters_accumulate_and_harvest(farmer_batch):
    opts = pdhg.PDHGOptions(tol=1e-6, max_iters=8_000, telemetry=True)
    st = pdhg.solve(farmer_batch.qp, opts)
    h = kcounters.harvest_state(st)
    assert h["pdhg_iterations_total"] > 0
    assert h["pdhg_restarts_total"] >= 1
    assert h["pdhg_windows_total"] >= 1
    ring = h["residual_ring"]
    assert ring.shape == (3, opts.telemetry_ring)
    assert np.isfinite(ring).any()
    assert h["pdhg_last_score_median"] <= 1e-4
    # counters persist across a warm re-solve (PH's pattern)
    st2 = pdhg.solve(farmer_batch.qp, opts, st)
    h2 = kcounters.harvest_state(st2)
    assert h2["pdhg_iterations_total"] >= h["pdhg_iterations_total"]
    # off by default: None, and the harvest says so
    st_off = pdhg.solve(farmer_batch.qp,
                        pdhg.PDHGOptions(tol=1e-6, max_iters=4_000))
    assert st_off.counters is None
    assert kcounters.harvest_state(st_off) is None


def _fused(batch, staleness=None, max_iterations=4, rel_gap=5e-3,
           bus=None, plane_telemetry=True, hub_extra=None):
    opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=10,
        pdhg=pdhg.PDHGOptions(tol=1e-7, telemetry=True))
    wd = fw.FusedWheelOptions()
    wopts = dataclasses.replace(
        wd,
        lag_pdhg=dataclasses.replace(wd.lag_pdhg, telemetry=plane_telemetry),
        xhat_pdhg=dataclasses.replace(wd.xhat_pdhg,
                                      telemetry=plane_telemetry))
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": rel_gap,
                                      **(hub_extra or {})}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": wopts}}
    if bus is not None:
        hub["hub_kwargs"]["options"]["telemetry_bus"] = bus
    if staleness is not None:
        hub["hub_class"], hub["opt_class"] = AsyncPHHub, aw.AsyncFusedPH
        hub["opt_kwargs"]["async_options"] = aw.AsyncWheelOptions(staleness)
    spokes = [{"spoke_class": spoke_mod.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke_mod.FusedXhatXbarInnerBound,
               "opt_kwargs": {"options": {}}}]
    return WheelSpinner(hub, spokes).spin()


def test_fused_plane_counters_harvested(farmer_batch):
    """--kernel-counters covers the fused bound planes, each under its
    own label, and the planes' counters start at zero after iter0."""
    metrics.REGISTRY.reset()
    ws = _fused(farmer_batch)
    for cyl in ("hub", "lag", "xhat"):
        assert metrics.REGISTRY.get("pdhg_iterations_total",
                                    cyl=cyl) > 0, cyl
    hub_total = kcounters.harvest_state(ws.opt.wstate.ph.solver)
    lag_total = kcounters.harvest_state(ws.opt.wstate.lag_solver)
    assert metrics.REGISTRY.get("pdhg_iterations_total", cyl="lag") \
        == lag_total["pdhg_iterations_total"]
    # iter0's 400 windows count once, under the hub
    assert lag_total["pdhg_windows_total"] \
        < hub_total["pdhg_windows_total"]


class _Probe:
    def __init__(self):
        self.seen = []

    def handle(self, e):
        self.seen.append(e)

    def close(self):
        pass


def test_pipelined_counter_harvest_never_undercounts(farmer_batch):
    probe = _Probe()
    bus = tel.EventBus()
    bus.subscribe(probe)
    metrics.REGISTRY.reset()
    ws = _fused(farmer_batch, staleness=1, max_iterations=6, rel_gap=0.0,
                bus=bus, plane_telemetry=False)
    direct = kcounters.harvest_state(ws.opt.state.solver,
                                     include_ring=False)
    for name in ("pdhg_iterations_total", "pdhg_restarts_total",
                 "pdhg_windows_total"):
        assert metrics.REGISTRY.get(name, cyl="hub") == direct[name]
    assert direct["pdhg_iterations_total"] > 0
    counts = Counter(e.hub_iter for e in probe.seen
                     if e.kind == "kernel-counters" and e.cyl == "hub")
    assert counts
    final = max(counts)
    assert all(c == 1 for it, c in counts.items() if it != final)
    assert counts[final] <= 2
    # one sync behind: the row stamped at sync k carries the totals of
    # the state sync k-1 began harvesting, so totals never decrease
    rows = [e.data for e in probe.seen if e.kind == "kernel-counters"]
    totals = [r["pdhg_iterations_total"] for r in rows]
    assert totals == sorted(totals)
    # the event's fields are the JAX package's
    assert set(rows[-1]) == {
        "pdhg_iterations_total", "pdhg_restarts_total",
        "pdhg_omega_adaptations_total", "pdhg_guard_resets_total",
        "pdhg_windows_total", "pdhg_last_score_median"}


def test_lane_quarantine_fires_on_a_lane_fault(farmer_batch):
    probe = _Probe()
    bus = tel.EventBus()
    bus.subscribe(probe)
    plan = FaultPlan(seed=1, lanes=(
        LaneFault(at_iter=2, lanes=(1,), mode="nan"),))
    opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=5, conv_thresh=0.0,
        subproblem_windows=10,
        pdhg=pdhg.PDHGOptions(tol=1e-7, lane_guard=True, telemetry=True))
    WheelSpinner({"hub_class": PHHub,
                  "hub_kwargs": {"options": {"rel_gap": 0.0,
                                             "telemetry_bus": bus,
                                             "fault_plan": plan}},
                  "opt_class": ph_mod.PH,
                  "opt_kwargs": {"options": opts, "batch": farmer_batch}},
                 []).spin()
    quarantines = [e for e in probe.seen if e.kind == "lane-quarantine"]
    assert len(quarantines) == 1
    q = quarantines[0]
    assert q.data["resets"] == q.data["total"] >= 1
    # the guard fired at the first restart after the fault (iteration
    # 2's step), harvested one sync behind
    assert q.hub_iter in (3, 4)
