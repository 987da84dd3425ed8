# Port parity: the async exchange wheel (algos/async_wheel.AsyncFusedPH +
# cylinders/hub.AsyncPHHub) — the mirror of tests/test_async_wheel.py on
# farmer S=3 with its farmer_ph_opts and FARMER_WOPTS:
#   * staleness 0 is the synchronous degrade: trace rows (minus `t`) and
#     bounds equal the port's sync pair;
#   * one ph_stale_step from a JAX state and plane matches the JAX step
#     (W, x̄, x to 1e-5 of their scale, theta to 1e-6 relative) and leaves
#     the plane untouched;
#   * the plane-write (slot, generation, staleness) sequence of 8
#     iterations equals JAX's exactly at staleness 1 and 2, and with
#     dropped/torn plane writes;
#   * staleness 1 and 2 certify 1% with the EF value -108390 inside the
#     bracket, within 2e-3 of the JAX async wheel's bounds (the sync
#     farmer tests' tolerance: both trajectories carry f32 floor noise,
#     ROADMAP C1);
#   * a wedged exchange trips the hub watchdog; plane tickets keep the
#     result-or-typed-SolveFailed contract; a contradictory staleness
#     mirror raises; uc at staleness 1 tracks the sync uc wheel.
import dataclasses
import time

import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import async_wheel as jaw
from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.resilience import faults as jfaults
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu import telemetry as jtel
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch import telemetry as ttel
from mpisppy_tpu_torch.algos import async_wheel as taw
from mpisppy_tpu_torch.algos import aph as taph
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.cylinders import hub as thub
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.dispatch.scheduler import (
    DispatchOptions, SolveFailed, SolveScheduler,
)
from mpisppy_tpu_torch.models import uc as tuc
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.resilience import faults as tfaults
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner

torch.set_num_threads(1)

FARMER_EF_OBJ = -108390.0
PKG = {
    "jax": (jph, jpdhg, jfw, jaw, jspoke, jhub, JWheelSpinner, jtel,
            jfaults),
    "torch": (tph, tpdhg, tfw, taw, tspoke, thub, TWheelSpinner, ttel,
              tfaults),
}


@pytest.fixture(scope="module")
def batches():
    jb = jbatch.from_specs([jfarmer.scenario_creator(nm, num_scens=3)
                            for nm in jfarmer.scenario_names_creator(3)])
    return {"jax": jb,
            "torch": convert.batch_from_arrays(convert.arrays_of(jb), "cpu")}


def wheel(pkg, batch, staleness=None, max_iterations=120, rel_gap=1e-2,
          hub_extra=None):
    """The JAX test's farmer wheel (farmer_ph_opts, FARMER_WOPTS, the
    four fused spokes): the sync pair (staleness None) or the async pair
    at `staleness`.  Returns (spinner, plane-write event data)."""
    ph_mod, pdhg, fw, aw, sm, hm, spinner, tel, _ = PKG[pkg]
    seen = []

    class Probe:
        def handle(self, e):
            if e.kind == "plane-write":
                seen.append(dict(e.data))

        def close(self):
            pass

    bus = tel.EventBus()
    bus.subscribe(Probe())
    hub_opts = {"rel_gap": rel_gap, "telemetry_bus": bus,
                **(hub_extra or {})}
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=max_iterations,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg.PDHGOptions(tol=1e-7))
    wopts = fw.FusedWheelOptions(
        slam_windows=2, shuffle_windows=4, slam_sense_max=False,
        lag_pdhg=pdhg.PDHGOptions(tol=1e-7),
        xhat_pdhg=pdhg.PDHGOptions(tol=1e-7, omega0=0.1,
                                   restart_period=80))
    d = {"hub_class": hm.PHHub, "hub_kwargs": {"options": hub_opts},
         "opt_class": fw.FusedPH,
         "opt_kwargs": {"options": opts, "batch": batch,
                        "wheel_options": wopts}}
    if staleness is not None:
        d["hub_class"] = hm.AsyncPHHub
        d["opt_class"] = aw.AsyncFusedPH
        d["opt_kwargs"]["async_options"] = aw.AsyncWheelOptions(
            staleness=staleness)
        hub_opts["async_staleness"] = staleness
    spokes = [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        sm.FusedLagrangianOuterBound, sm.FusedXhatXbarInnerBound,
        sm.FusedXhatShuffleInnerBound, sm.FusedSlamHeuristic)]
    ws = spinner(d, spokes).spin()
    return ws, seen


def trace_rows(ws):
    return [{k: v for k, v in row.items() if k != "t"}
            for row in ws.spcomm.trace]


def certified(ws, rel_gap=1e-2):
    inner, outer = ws.BestInnerBound, ws.BestOuterBound
    assert np.isfinite(inner) and np.isfinite(outer)
    assert outer <= inner + 2e-3 * abs(inner)
    assert (inner - outer) / abs(inner) <= rel_gap + 1e-6
    assert outer <= FARMER_EF_OBJ <= inner
    return outer, inner


@pytest.fixture(scope="module")
def runs(batches):
    """The farmer wheels several tests share: the port's sync pair and
    both packages' async pairs at staleness 1 and 2, to 1%."""
    out = {"sync": wheel("torch", batches["torch"])[0]}
    for pkg in ("torch", "jax"):
        for s in (1, 2):
            out[pkg, s] = wheel(pkg, batches[pkg], staleness=s)[0]
    return out


def test_staleness0_equals_the_sync_wheel(batches, runs):
    ws0, events = wheel("torch", batches["torch"], staleness=0)
    ws = runs["sync"]
    assert ws0.BestOuterBound == ws.BestOuterBound
    assert ws0.BestInnerBound == ws.BestInnerBound
    assert trace_rows(ws0) == trace_rows(ws)
    assert events == [] and ws0.opt.last_theta is None


def test_ph_stale_step_matches_jax(batches):
    """One theta-damped step from the JAX state after iteration 1,
    against the iter0 plane (staleness 1), in both packages."""
    jb, tb = batches["jax"], batches["torch"]
    jo = jph.kernel_opts(jph.PHOptions(default_rho=1.0,
                                       subproblem_windows=10,
                                       pdhg=jpdhg.PDHGOptions(tol=1e-7)))
    to = tph.PHOptions(default_rho=1.0, subproblem_windows=10,
                       pdhg=tpdhg.PDHGOptions(tol=1e-7))
    import jax.numpy as jnp
    rho = jnp.ones((jb.num_nonants,), jnp.float32)
    jst0, _, _ = jph.ph_iter0(jb, rho, jo)
    jplane = jfw.plane_of(jst0)
    jst1 = jph.ph_iterk(jb, jst0, jo)
    jout, jtheta = jfw.ph_stale_step(jb, jst1, jplane, jo)
    tst1 = convert.ph_state_from_arrays(convert.arrays_of(jst1), "cpu")
    tplane = tfw.ExchangePlane(**{
        k: torch.as_tensor(np.array(v))
        for k, v in convert.arrays_of(jplane).items()})
    before = {f.name: getattr(tplane, f.name).clone()
              for f in dataclasses.fields(tplane)}
    tout, ttheta = tfw.ph_stale_step(tb, tst1, tplane, to)
    for name, j, t in (("W", jout.W, tout.W), ("xbar", jout.xbar, tout.xbar),
                       ("x", jout.solver.x, tout.solver.x)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max(),
                                   err_msg=name)
    assert float(ttheta) == pytest.approx(float(jtheta), rel=1e-6)
    for name, t in before.items():
        assert torch.equal(getattr(tplane, name), t), name


@pytest.mark.parametrize("staleness", [1, 2])
def test_plane_events_match_jax(batches, staleness):
    seqs = {pkg: wheel(pkg, batches[pkg], staleness=staleness,
                       max_iterations=8, rel_gap=0.0)[1]
            for pkg in ("jax", "torch")}
    assert len(seqs["torch"]) == 8
    assert seqs["torch"] == seqs["jax"]
    assert all(e["staleness"] == staleness for e in seqs["torch"][1:])


@pytest.mark.parametrize("staleness", [1, 2])
def test_staleness_certifies_and_matches_jax(runs, staleness):
    tws, jws = runs["torch", staleness], runs["jax", staleness]
    out_t, in_t = certified(tws)
    out_j, in_j = certified(jws)
    assert abs(out_t - out_j) <= 2e-3 * abs(out_j)
    assert abs(in_t - in_j) <= 2e-3 * abs(in_j)
    # the theta damping engaged (the pipelined host read)
    assert 0.0 <= tws.opt.last_theta <= 1.0


def test_exchange_faults_match_jax(batches):
    """Dropped and torn plane writes: the same fault schedule gives the
    same plane-write sequence in both packages (the dropped/torn slots
    show staleness above the bound), and the faulted port wheel still
    certifies 1% around the EF value."""
    def plan(fx):
        return fx.FaultPlan(seed=11, exchanges=(
            fx.AsyncExchangeFault("drop_plane_write", at_iters=(3, 9)),
            fx.AsyncExchangeFault("torn_swap", at_iters=(5, 12))))
    out = {}
    for pkg in ("jax", "torch"):
        p = plan(PKG[pkg][8])
        ws, events = wheel(pkg, batches[pkg], staleness=1,
                           max_iterations=20, rel_gap=0.0,
                           hub_extra={"fault_plan": p})
        out[pkg] = (ws, events, p)
    tws, tevents, tplan = out["torch"]
    assert tevents == out["jax"][1]
    assert len(tevents) == 20 and max(e["staleness"] for e in tevents) > 1
    assert [d for _, d in tplan.fired] == [d for _, d in out["jax"][2].fired]
    certified(tws)


def test_watchdog_trips_on_wedged_exchange(batches, tmp_path):
    """A slow harvest far past the watchdog budget trips the watchdog
    (abort_fn injected) while the hub sits in iteration 4's exchange;
    the abort first writes an emergency checkpoint of that iteration."""
    plan = tfaults.FaultPlan(seed=12, exchanges=(
        tfaults.AsyncExchangeFault("slow_harvest", at_iters=(4,),
                                   delay_s=4.0),))
    trips = []
    ckpt = str(tmp_path / "wd.npz")
    hub_opts = {"fault_plan": plan, "watchdog_budget_s": 1.5,
                "watchdog_interval_s": 0.05, "watchdog_action": "abort",
                "checkpoint_path": ckpt, "checkpoint_every_s": 1e9}
    # build first, then inject abort_fn before the watchdog can trip
    # a short iter0: every sync, iter0's included, lands well inside
    # the budget, so the one trip is the wedged exchange's
    opts = tph.PHOptions(default_rho=1.0, max_iterations=6,
                         conv_thresh=0.0, subproblem_windows=10,
                         iter0_windows=40,
                         pdhg=tpdhg.PDHGOptions(tol=1e-7))
    d = {"hub_class": thub.AsyncPHHub,
         "hub_kwargs": {"options": {"rel_gap": 0.0, **hub_opts}},
         "opt_class": taw.AsyncFusedPH,
         "opt_kwargs": {"options": opts, "batch": batches["torch"],
                        "async_options": taw.AsyncWheelOptions(1)}}
    sp = [{"spoke_class": tspoke.FusedLagrangianOuterBound,
           "opt_kwargs": {"options": {}}}]
    ws = TWheelSpinner(d, sp).build()
    ws.spcomm._watchdog.abort_fn = \
        lambda code: trips.append((code, ws.spcomm._iter))
    ws.spin()
    assert trips == [(75, 4)]
    assert ws.spcomm._watchdog.trips == 1
    with np.load(ckpt) as d:
        assert int(d["hub_iter"]) == 4
        assert bytes(d["which"]).decode() == "wstate"


class _Event:
    """A stand-in CUDA event for a CPU ticket: ready after `delay_s`
    (an injected device delay), or failing on synchronize."""

    def __init__(self, delay_s=0.0, fail=False):
        self.t0, self.delay_s, self.fail = time.perf_counter(), delay_s, fail

    def query(self):
        return not self.fail and time.perf_counter() - self.t0 >= self.delay_s

    def synchronize(self):
        if self.fail:
            raise RuntimeError("CUDA error: device-side assert")
        while not self.query():
            time.sleep(0.01)


def _ticket(sched, delay_s=0.0, fail=False, **kw):
    t = sched.submit_plane(lambda v: v + 1.0, torch.ones(()), **kw)
    t._ready = _Event(delay_s, fail)
    return t


def test_plane_ticket_deadline_and_fast_path():
    sched = SolveScheduler(DispatchOptions())
    t = sched.submit_plane(lambda v: v * 2, torch.ones(4), label="ok")
    assert torch.equal(t.result(), torch.full((4,), 2.0)) and t.done()
    t0 = time.perf_counter()
    with pytest.raises(SolveFailed) as ei:
        _ticket(sched, 30.0, label="wedged", deadline_s=0.1).result()
    assert ei.value.reason == "deadline"
    assert time.perf_counter() - t0 < 5.0, "wait was not bounded"
    # an expired deadline on a result that already landed is no miss
    late = _ticket(sched, 0.0, label="late", deadline_s=0.05)
    time.sleep(0.1)
    assert float(late.result()) == 2.0
    # past the deadline an explicit timeout grants a recovery wait
    rec = _ticket(sched, 0.3, label="recover", deadline_s=0.05)
    time.sleep(0.1)
    assert rec.result(timeout=5.0) is rec.value
    with pytest.raises(SolveFailed):
        _ticket(sched, 30.0, label="bare", deadline_s=-1.0).result()
    st = sched.stats()
    assert st["plane_tickets"] == 5
    assert st["plane_deadline_misses"] == 2


def test_plane_ticket_failed_dispatch_is_typed():
    sched = SolveScheduler(DispatchOptions())
    for kw in ({}, {"deadline_s": 30.0}):
        with pytest.raises(SolveFailed) as ei:
            _ticket(sched, fail=True, label="boom", **kw).result()
        assert ei.value.reason == "exception"
    with pytest.raises(SolveFailed) as ei:
        _ticket(sched, fail=True, label="boom-wait",
                deadline_s=30.0).result(timeout=30.0)
    assert ei.value.reason == "exception"
    assert sched.stats()["plane_deadline_misses"] == 0


def test_async_staleness_refuses_a_contradictory_mirror():
    class Opt:
        async_options = taw.AsyncWheelOptions(staleness=2)
    hub = thub.AsyncPHHub.__new__(thub.AsyncPHHub)
    hub.opt, hub.options = Opt(), {"async_staleness": 1}
    with pytest.raises(ValueError, match="mismatch"):
        hub._async_staleness()
    hub.options = {"async_staleness": 2}
    assert hub._async_staleness() == 2
    hub.opt = object()
    assert hub._async_staleness() == 2


def test_projective_theta_rejects_an_adverse_plane(batches):
    """APH's Step-16 rejection is reachable: a plane whose era duals
    point against the iterate gives theta 0 (pre-floor)."""
    tb = batches["torch"]
    g = np.random.default_rng(7)
    S, N = tb.num_scenarios, tb.num_nonants
    x, z, W = (torch.as_tensor(g.normal(size=(S, N)), dtype=torch.float32)
               for _ in range(3))
    xbar, _ = tb.node_average(x)
    rho = torch.ones(N)
    assert float(taph.projective_theta(tb, x, xbar, W, z, W, rho)) > 0.0
    W_plane = W - 2.0 * rho * (x - z)
    assert float(taph.projective_theta(tb, x, xbar, W, z, W_plane,
                                       rho)) == 0.0


def test_uc_staleness1_tracks_the_sync_wheel():
    """uc S=4 (the JAX test's 4-generator, 12-hour instance) over a few
    hub iterations: the async wheel at staleness 1 publishes bounds of
    the sync wheel's order, each bracket consistent."""
    inst = tuc.synthetic_instance(4, 12, seed=1)
    tb = tbatch.from_specs([tuc.scenario_creator(nm, instance=inst,
                                                 num_scens=4)
                            for nm in tuc.scenario_names_creator(4)],
                           device="cpu")
    opts = tph.PHOptions(default_rho=200.0, max_iterations=6,
                         conv_thresh=0.0, subproblem_windows=10,
                         pdhg=tpdhg.PDHGOptions(tol=1e-7))
    res = {}
    for s in (None, 1):
        d = {"hub_class": thub.PHHub,
             "hub_kwargs": {"options": {"rel_gap": 0.0}},
             "opt_class": tfw.FusedPH,
             "opt_kwargs": {"options": opts, "batch": tb}}
        if s is not None:
            d["hub_class"], d["opt_class"] = thub.AsyncPHHub, \
                taw.AsyncFusedPH
            d["opt_kwargs"]["async_options"] = taw.AsyncWheelOptions(s)
        sp = [{"spoke_class": c, "opt_kwargs": {"options": {}}}
              for c in (tspoke.FusedLagrangianOuterBound,
                        tspoke.FusedXhatXbarInnerBound)]
        res[s] = TWheelSpinner(d, sp).spin()
    for ws in res.values():
        assert np.isfinite(ws.BestOuterBound)
        if np.isfinite(ws.BestInnerBound):
            assert ws.BestOuterBound <= ws.BestInnerBound + 2e-3 * abs(
                ws.BestInnerBound)
    tol = 5e-2 * max(1.0, abs(res[None].BestOuterBound))
    assert abs(res[1].BestOuterBound - res[None].BestOuterBound) <= tol
    assert res[1].spcomm._iter == res[None].spcomm._iter == 7


def test_fuse_wheel_swaps_in_the_async_pair():
    from mpisppy_tpu_torch import generic_cylinders as gc
    from mpisppy_tpu_torch.utils.config import Config

    def cfg(extra):
        c = Config()
        c.popular_args()
        c.fused_wheel_args()
        c.parse_command_line("t", ["--fused-wheel"] + extra)
        return c

    base = {"hub_class": thub.PHHub, "hub_kwargs": {"options": {}},
            "opt_kwargs": {"options": tph.PHOptions()}}
    sp = [{"spoke_class": tspoke.LagrangianOuterBound,
           "opt_kwargs": {"options": {}}}]
    hub, _ = gc._fuse_wheel(cfg(["--async-staleness", "2",
                                 "--async-exchange-deadline-s", "2.5"]),
                            dict(base), sp)
    assert hub["hub_class"] is thub.AsyncPHHub
    assert hub["opt_class"] is taw.AsyncFusedPH
    assert hub["opt_kwargs"]["async_options"].staleness == 2
    assert hub["opt_kwargs"]["async_options"].exchange_deadline_s == 2.5
    assert hub["hub_kwargs"]["options"]["async_staleness"] == 2
    hub0, _ = gc._fuse_wheel(cfg([]), dict(base), sp)
    assert hub0["hub_class"] is thub.PHHub
    assert hub0["opt_class"] is tfw.FusedPH
    assert "async_options" not in hub0["opt_kwargs"]
