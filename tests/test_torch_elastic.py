# Port parity: the elastic mesh fault domain
# (mpisppy_tpu_torch/parallel/elastic.py) — the cases of
# tests/test_elastic.py on the port: the host membership ladder (UP ->
# SUSPECT -> sticky DEAD with epochs), beacons, the MeshFault seams that
# fire once, the bounded hub harvest (typed MeshDegraded, never a hang)
# and the torn re-fetch, adapt_checkpoint_arrays bit-identical to the
# JAX package's on the same arrays, survivor groups over ranks,
# re-partitioning with zero-probability pad lanes, the watchdog's shrink
# ladder, and the checkpoint transform applied after the integrity
# check.  The end-to-end re-shard lives in tests/test_torch_mesh_chaos.py,
# the multi-process round trip in tests/test_torch_multihost.py.
import os
import time

import numpy as np
import pytest

import torch

from mpisppy_tpu.parallel import elastic as jelastic
from mpisppy_tpu_torch.parallel import elastic, mesh as mesh_mod
from mpisppy_tpu_torch.resilience import (
    FaultPlan, MeshFault, PreemptionError,
)
from mpisppy_tpu_torch.telemetry import EventBus
from mpisppy_tpu_torch.telemetry import metrics as _metrics

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos


class _Cap:
    def __init__(self):
        self.events = []

    def handle(self, event):
        self.events.append(event)

    def kinds(self):
        return [e.kind for e in self.events]


# ---------------------------------------------------------------------------
# membership: the fleet health ladder applied to mesh hosts
# ---------------------------------------------------------------------------
def test_membership_ladder_suspect_then_dead_sticky():
    cap = _Cap()
    bus = EventBus()
    bus.subscribe(cap)
    mm = elastic.MeshMembership(3, dead_after=2, bus=bus, run="t")
    assert mm.state(1) == elastic.UP and mm.epoch == 0
    assert mm.observe(1, fresh=False) == elastic.SUSPECT
    assert mm.live_hosts() == [0, 1, 2]  # suspicion alone never reshards
    assert mm.observe(1, fresh=False) == elastic.DEAD
    assert mm.dead_hosts() == [1] and mm.live_hosts() == [0, 2]
    # sticky: a zombie's late beat must NOT resurrect it (fencing)
    assert mm.observe(1, fresh=True) is None
    assert mm.state(1) == elastic.DEAD
    assert mm.epoch == 2
    states = [e.data["state"] for e in cap.events
              if e.kind == "mesh-state"]
    assert states == ["SUSPECT", "DEAD"]


def test_membership_partition_heals_without_reshard():
    cap = _Cap()
    bus = EventBus()
    bus.subscribe(cap)
    mm = elastic.MeshMembership(2, dead_after=3, bus=bus, run="t")
    mm.observe(1, fresh=False)
    assert mm.state(1) == elastic.SUSPECT
    assert mm.observe(1, fresh=True) == elastic.UP
    healed = [e for e in cap.events if e.kind == "mesh-state"
              and e.data["reason"] == "partition-healed"]
    assert len(healed) == 1
    # epoch moved (two transitions) but nobody died: no reshard signal
    assert mm.epoch == 2 and mm.dead_hosts() == []


def test_membership_beacon_files(tmp_path):
    d = str(tmp_path)
    writer = elastic.MeshMembership(2, dead_after=2, self_host=1,
                                    beacon_dir=d)
    poller = elastic.MeshMembership(2, dead_after=2, self_host=0,
                                    beacon_dir=d)
    writer.beat(1)
    assert os.path.exists(os.path.join(d, "host1.beat"))
    assert poller.poll() == [] and poller.state(1) == elastic.UP
    # no new beat: the same counter is stale on the next two sweeps
    assert poller.poll() == []
    assert poller.state(1) == elastic.SUSPECT
    assert poller.poll() == [1]
    assert poller.state(1) == elastic.DEAD
    # gauges track the poller's view
    assert _metrics.REGISTRY.get("mesh_hosts_up") == 1.0


def test_partition_seam_suppresses_beacon(tmp_path):
    d = str(tmp_path)
    plan = FaultPlan(seed=0, meshes=(
        MeshFault("partition", host=1, at_beats=(1, 2)),))
    mm = elastic.MeshMembership(2, dead_after=5, self_host=1,
                                beacon_dir=d)
    assert mm.beat(1, plan=plan)           # beat 0: delivered
    assert not mm.beat(1, plan=plan)       # beats 1, 2: suppressed
    assert not mm.beat(1, plan=plan)
    assert mm.beat(1, plan=plan)           # beat 3: window over
    with open(os.path.join(d, "host1.beat")) as f:
        assert int(f.read()) == 3
    assert ("mesh", "partition host1@beat1") in plan.fired


# ---------------------------------------------------------------------------
# MeshFault seams on the plan
# ---------------------------------------------------------------------------
def test_mesh_fault_validates_kind():
    with pytest.raises(ValueError):
        MeshFault("meteor")


def test_host_lost_seam_fires_once():
    plan = FaultPlan(seed=1, meshes=(
        MeshFault("host_lost", host=1, at_iters=(3,)),))
    assert plan.armed
    assert plan.mesh_lost_host(2) is None
    assert plan.mesh_lost_host(3) == 1
    assert plan.mesh_lost_host(3) is None   # fired once
    assert plan.mesh_lost_host(4) is None
    assert ("mesh", "host_lost host1 iter3") in plan.fired


def test_straggler_seam_fires_once_per_iteration():
    plan = FaultPlan(seed=1, meshes=(
        MeshFault("straggler", at_iters=(5,), delay_s=0.25),))
    assert plan.mesh_harvest_delay(4) == 0.0
    assert plan.mesh_harvest_delay(5) == 0.25
    # a resumed run re-executing iter 5 must not re-straggle (the
    # injected collective was transiently slow — a re-trip would
    # livelock the elastic runner into its max_reshards budget)
    assert plan.mesh_harvest_delay(5) == 0.0


def test_torn_harvest_seam_fires_once_per_iteration():
    plan = FaultPlan(seed=1, meshes=(
        MeshFault("torn_harvest", at_iters=(2,)),))
    assert not plan.mesh_torn_harvest(1)
    assert plan.mesh_torn_harvest(2)
    assert not plan.mesh_torn_harvest(2)


# ---------------------------------------------------------------------------
# the bounded harvest: result, typed error, or re-fetch — never a hang
# ---------------------------------------------------------------------------
def test_harvest_deadline_trips_typed_mesh_degraded():
    cap = _Cap()
    bus = EventBus()
    bus.subscribe(cap)
    before = _metrics.REGISTRY.get("mesh_stragglers_total")
    rt = elastic.MeshRuntime(deadline_s=0.05, bus=bus, run="t")
    with pytest.raises(elastic.MeshDegraded) as ei:
        rt.harvest(lambda: (time.sleep(5.0), np.ones(3))[1], hub_iter=7)
    assert ei.value.reason == "straggler-deadline"
    assert ei.value.hub_iter == 7
    assert isinstance(ei.value, PreemptionError)  # the unwind contract
    assert _metrics.REGISTRY.get("mesh_stragglers_total") == before + 1
    ev = [e for e in cap.events if e.kind == "mesh-straggler"]
    assert ev and ev[0].data["mode"] == "deadline"


def test_harvest_straggler_under_deadline_survives():
    plan = FaultPlan(seed=2, meshes=(
        MeshFault("straggler", at_iters=(1,), delay_s=0.02),))
    rt = elastic.MeshRuntime(plan=plan, deadline_s=5.0)
    vals = rt.harvest(lambda: np.arange(3.0), hub_iter=1)
    np.testing.assert_array_equal(vals, np.arange(3.0))
    assert ("mesh", "straggler +0.02s iter1") in plan.fired


def test_harvest_torn_transfer_refetches_intact_value():
    cap = _Cap()
    bus = EventBus()
    bus.subscribe(cap)
    before = _metrics.REGISTRY.get("mesh_torn_harvests_total")
    plan = FaultPlan(seed=2, meshes=(
        MeshFault("torn_harvest", at_iters=(4,)),))
    rt = elastic.MeshRuntime(plan=plan, bus=bus, run="t")
    vals = rt.harvest(lambda: np.arange(4.0), hub_iter=4)
    # the tear NaN'd the transfer; the device value was intact and the
    # synchronous re-fetch recovered it
    np.testing.assert_array_equal(vals, np.arange(4.0))
    assert _metrics.REGISTRY.get("mesh_torn_harvests_total") == before + 1
    ev = [e for e in cap.events if e.kind == "mesh-straggler"]
    assert ev and ev[0].data["mode"] == "torn"


def test_harvest_genuinely_nonfinite_passes_through():
    # both fetches non-finite: NOT a tear — the hub's own bound guards
    # own this case, the mesh must not mask it
    before = _metrics.REGISTRY.get("mesh_torn_harvests_total")
    rt = elastic.MeshRuntime()
    vals = rt.harvest(lambda: np.array([np.nan, 1.0]), hub_iter=0)
    assert np.isnan(vals[0])
    assert _metrics.REGISTRY.get("mesh_torn_harvests_total") == before


def test_harvest_host_lost_raises_and_fences():
    cap = _Cap()
    bus = EventBus()
    bus.subscribe(cap)
    plan = FaultPlan(seed=3, meshes=(
        MeshFault("host_lost", host=1, at_iters=(6,)),))
    mm = elastic.MeshMembership(2, bus=bus, run="t")
    rt = elastic.MeshRuntime(mm, plan=plan, bus=bus, run="t")
    assert rt.harvest(lambda: np.zeros(2), hub_iter=5).shape == (2,)
    with pytest.raises(elastic.MeshDegraded) as ei:
        rt.harvest(lambda: np.zeros(2), hub_iter=6)
    assert ei.value.reason == "host-lost" and ei.value.host == 1
    assert mm.state(1) == elastic.DEAD
    lost = [e for e in cap.events if e.kind == "mesh-host-lost"]
    assert lost and lost[0].data["survivors"] == [0]


# ---------------------------------------------------------------------------
# survivor groups over ranks + checkpoint re-shard adaptation
# ---------------------------------------------------------------------------
def test_device_groups_and_survivors():
    devs = list(range(8))            # ranks, or one process's slots
    groups = elastic.device_groups(devs, 4)
    assert groups == [[0, 1], [2, 3], [4, 5], [6, 7]]
    surv = elastic.survivor_devices(devs, 4, dead_hosts=[1])
    assert surv == [0, 1, 4, 5, 6, 7]
    # the JAX package's grouping of a single process's devices, by index
    assert groups == [[d.id for d in g] for g in jelastic.device_groups(
        __import__("jax").devices()[:8], 4)]


def _checkpoint_like(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "leaf0": rng.normal(size=(8, 2)).astype(np.float32),
        "leaf1": rng.normal(size=8),                  # scenario vector
        "leaf2": rng.normal(size=4),                  # not scenario-major
        "leaf3": rng.integers(0, 9, size=(8, 3)).astype(np.int32),
        "leaf4": np.asarray(3, np.int32),             # a host int
        "bounds": np.array([1.0, 2.0]),               # meta: untouched
    }


@pytest.mark.parametrize("num_real,s_old,s_new", [
    (5, 8, 6), (5, 8, 5), (5, 8, 12), (8, 8, 8), (3, 8, 4)])
def test_adapt_checkpoint_arrays_bit_identical_to_jax(num_real, s_old,
                                                      s_new):
    arrays = _checkpoint_like()
    got = elastic.adapt_checkpoint_arrays(arrays, num_real, s_old, s_new)
    want = jelastic.adapt_checkpoint_arrays(arrays, num_real, s_old, s_new)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    if s_old == s_new:
        assert got is arrays


def test_adapt_checkpoint_arrays_repads_scenario_leaves():
    arrays = {
        "leaf0": np.arange(8 * 2, dtype=np.float32).reshape(8, 2),
        "leaf1": np.arange(8.0),
        "leaf2": np.arange(4.0),
        "bounds": np.array([1.0, 2.0]),
    }
    out = elastic.adapt_checkpoint_arrays(arrays, num_real=5,
                                          s_old=8, s_new=6)
    assert out["leaf0"].shape == (6, 2)
    np.testing.assert_array_equal(out["leaf0"][:5], arrays["leaf0"][:5])
    np.testing.assert_array_equal(out["leaf0"][5], arrays["leaf0"][4])
    assert out["leaf1"].shape == (6,)
    np.testing.assert_array_equal(out["leaf2"], arrays["leaf2"])
    np.testing.assert_array_equal(out["bounds"], arrays["bounds"])


# ---------------------------------------------------------------------------
# re-partitioning: pad lanes carry ZERO probability mass
# ---------------------------------------------------------------------------
def test_repartition_zero_probability_pads():
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.scengen.virtual import repartition

    prog = farmer.scenario_program(13, seed=0)
    vb = scengen.virtual_batch(prog, device="cpu")
    rp = repartition(vb, 6)
    assert rp.num_scenarios == 18 and rp.num_real == 13
    p = rp.p.numpy()
    np.testing.assert_allclose(p[:13], vb.p.numpy()[:13])
    np.testing.assert_array_equal(p[13:], np.zeros(5))
    assert float(p.sum()) == pytest.approx(float(vb.p.sum()))


def test_shard_batch_pad_true_uneven_survivors_value_identical():
    """S=13 real scenarios on a 6-slot survivor mesh re-pad to 18, on the
    8-slot mesh to 16: the p-weighted reductions agree up to f32
    reduction order (test_sharding.py's layout tolerances)."""
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.models import farmer

    prog = farmer.scenario_program(13, seed=0)
    opts = ph_mod.PHOptions(subproblem_windows=2, iter0_windows=20)
    rho = torch.ones(3)
    b8 = mesh_mod.shard_batch(scengen.virtual_batch(prog, device="cpu"),
                              mesh_mod.make_mesh(8), pad=True)
    b6 = mesh_mod.shard_batch(scengen.virtual_batch(prog, device="cpu"),
                              mesh_mod.make_mesh(6), pad=True)
    assert (b8.num_scenarios, b6.num_scenarios) == (16, 18)
    st8, tb8, _ = ph_mod.ph_iter0(b8, rho, opts)
    st6, tb6, _ = ph_mod.ph_iter0(b6, rho, opts)
    assert float(tb6) == pytest.approx(float(tb8), rel=1e-4)
    np.testing.assert_allclose(st6.xbar[0].numpy(), st8.xbar[0].numpy(),
                               rtol=5e-3, atol=1e-2)


def test_shard_batch_pad_true_materialized_batch():
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import farmer

    specs = [farmer.scenario_creator(nm, num_scens=3)
             for nm in farmer.scenario_names_creator(3)]
    b = batch_mod.from_specs(specs, device="cpu")
    b6 = mesh_mod.shard_batch(b, mesh_mod.make_mesh(6), pad=True)
    assert b6.num_scenarios == 6
    np.testing.assert_array_equal(b6.p[3:].numpy(), np.zeros(3))
    assert float(b6.p.sum()) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        mesh_mod.shard_batch(b, mesh_mod.make_mesh(6))


# ---------------------------------------------------------------------------
# watchdog shrink rung: degrade -> shrink -> abort, never wedged
# ---------------------------------------------------------------------------
class _HubStub:
    telemetry = None
    run_id = "t"
    options: dict = {}


def _trip_n(wd, n):
    for _ in range(n):
        wd._trip(999.0)


def test_watchdog_shrink_ladder():
    from mpisppy_tpu_torch.resilience.watchdog import HubWatchdog
    calls, aborts = [], []
    wd = HubWatchdog(_HubStub(), budget_s=1e9, action="shrink",
                     abort_fn=aborts.append,
                     shrink_fn=lambda stalled: calls.append(stalled) or True)
    _trip_n(wd, 1)
    assert wd.degraded and not wd.shrunk and not aborts
    _trip_n(wd, 1)
    assert wd.shrunk and len(calls) == 1 and not aborts
    _trip_n(wd, 1)
    assert aborts == [75]


def test_watchdog_failed_shrink_escalates_to_abort():
    from mpisppy_tpu_torch.resilience.watchdog import HubWatchdog
    aborts = []

    def bad_shrink(stalled):
        raise RuntimeError("no survivors")

    wd = HubWatchdog(_HubStub(), budget_s=1e9, action="shrink",
                     abort_fn=aborts.append, shrink_fn=bad_shrink)
    _trip_n(wd, 3)
    assert not wd.shrunk and aborts == [75]


def test_watchdog_shrink_without_fn_degrades_then_aborts():
    from mpisppy_tpu_torch.resilience.watchdog import HubWatchdog
    aborts = []
    wd = HubWatchdog(_HubStub(), budget_s=1e9, action="shrink",
                     abort_fn=aborts.append)
    _trip_n(wd, 2)
    assert wd.degraded and aborts == [75]


def test_hub_passes_the_shrink_fn():
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.models import farmer

    b = batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3)
         for nm in farmer.scenario_names_creator(3)], device="cpu")
    fn = lambda stalled: True   # noqa: E731
    hub = PHHub(ph_mod.PH(ph_mod.PHOptions(), b),
                {"watchdog_budget_s": 1e9, "watchdog_action": "shrink",
                 "watchdog_shrink_fn": fn})
    try:
        assert hub._watchdog.shrink_fn is fn
        assert hub._watchdog.action == "shrink"
    finally:
        hub._watchdog.stop()


# ---------------------------------------------------------------------------
# load_checkpoint transform hook (the reshard adaptation seam)
# ---------------------------------------------------------------------------
def _ph_spinner(batch, extra=None):
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    return WheelSpinner({
        "hub_class": PHHub,
        "hub_kwargs": {"options": {"rel_gap": 5e-3, **(extra or {})}},
        "opt_class": ph_mod.PH,
        "opt_kwargs": {"options": ph_mod.PHOptions(
            default_rho=1.0, max_iterations=3, conv_thresh=0.0,
            subproblem_windows=4), "batch": batch},
    }).build()


def test_load_checkpoint_transform_applied_after_integrity(tmp_path):
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import farmer

    b = batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3)
         for nm in farmer.scenario_names_creator(3)], device="cpu")
    ws = _ph_spinner(b)
    ws.spcomm.main()
    ckpt = str(tmp_path / "w.npz")
    assert ws.spcomm.save_checkpoint(ckpt)

    seen = {}

    def transform(arrays):
        seen["n_leaves"] = sum(1 for k in arrays if k.startswith("leaf"))
        seen["has_crc"] = "crc" in arrays
        return arrays

    ws2 = _ph_spinner(b)
    ws2.spcomm.load_checkpoint(ckpt, transform=transform)
    assert seen["n_leaves"] > 0
    assert seen["has_crc"] is False        # checked and removed first
    assert ws2.spcomm._iter == ws.spcomm._iter
    # a corrupt file never reaches the transform
    with np.load(ckpt) as d:
        arrays = {k: np.array(d[k]) for k in d.files}
    arrays["leaf0"] = arrays["leaf0"] + 1.0
    with open(ckpt, "wb") as f:
        np.savez(f, **arrays)
    seen.clear()
    with pytest.raises(FileNotFoundError, match="checksum"):
        _ph_spinner(b).spcomm.load_checkpoint(ckpt, transform=transform)
    assert not seen


def test_transform_repads_a_checkpoint_onto_another_layout(tmp_path):
    """The elastic seam end to end on one process: a PH snapshot of the
    S=13 program on the 8-slot layout (16 rows) restores onto the 6-slot
    layout (18 rows) through adapt_checkpoint_arrays, its real rows
    equal."""
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.models import farmer

    prog = farmer.scenario_program(13, seed=0)

    def batch(slots):
        return mesh_mod.shard_batch(
            scengen.virtual_batch(prog, device="cpu"),
            mesh_mod.make_mesh(slots), pad=True)
    ws = _ph_spinner(batch(8))
    ws.spcomm.main()
    ckpt = str(tmp_path / "r.npz")
    assert ws.spcomm.save_checkpoint(ckpt)
    ws2 = _ph_spinner(batch(6))
    ws2.spcomm.load_checkpoint(ckpt, transform=lambda a: (
        elastic.adapt_checkpoint_arrays(a, 13, 16, 18)))
    assert ws2.opt.state.W.shape[0] == 18
    assert torch.equal(ws2.opt.state.W[:13], ws.opt.state.W[:13])
    assert torch.equal(ws2.opt.state.W[13:],
                       ws.opt.state.W[12:13].expand(5, -1))
