# Port parity: the mesh chaos storm of tests/test_mesh_chaos.py on the
# port (mpisppy_tpu_torch/parallel/elastic.run_elastic, one process, a
# mesh of 8 device slots over 4 hosts): a host dies in the middle of the
# sharded fused wheel; the elastic loop re-pads the scenario axis across
# the survivors (16 -> 18 rows), resumes from the emergency checkpoint
# and still certifies the same gap as the fault-free run.  The trace of
# the kill, the re-shard and the resumed attempt is one causal tree.
import numpy as np
import pytest

import torch

from mpisppy_tpu_torch import scengen
from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.algos import fused_wheel as fw
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.cylinders.spoke import (
    FusedLagrangianOuterBound, FusedXhatXbarInnerBound,
)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.parallel import mesh as mesh_mod
from mpisppy_tpu_torch.parallel.elastic import run_elastic
from mpisppy_tpu_torch.resilience import FaultPlan, MeshFault
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.telemetry import EventBus
from mpisppy_tpu_torch.telemetry import metrics as _metrics

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

NUM_HOSTS = 4   # 8 device slots -> 2 per host
SLOTS = list(range(8))
S = 13          # prime: pads to 16 on 8 devices and to 18 on 6
REL_GAP = 5e-3

# minimal certified plane set: one outer (Lagrangian) + one inner
# (xhat-xbar) window so every seed shares the same two compiled shapes
_WOPTS = fw.FusedWheelOptions(lag_windows=4, xhat_windows=2,
                              slam_windows=0, shuffle_windows=0,
                              split_dispatch=False,
                              lag_pdhg=pdhg.PDHGOptions(tol=1e-7),
                              xhat_pdhg=pdhg.PDHGOptions(
                                  tol=1e-7, omega0=0.1,
                                  restart_period=80))
_SPOKES = [
    {"spoke_class": FusedLagrangianOuterBound,
     "opt_kwargs": {"options": {}}},
    {"spoke_class": FusedXhatXbarInnerBound,
     "opt_kwargs": {"options": {}}},
]


class _Cap:
    def __init__(self):
        self.events = []

    def handle(self, event):
        self.events.append(event)

    def kinds(self):
        return [e.kind for e in self.events]


def _build_fn(prog, ckpt, max_iterations=80):
    def build(mesh):
        b = mesh_mod.shard_batch(
            scengen.virtual_batch(prog, device="cpu"), mesh, pad=True)
        opts = ph_mod.PHOptions(default_rho=1.0,
                                max_iterations=max_iterations,
                                conv_thresh=0.0, subproblem_windows=10,
                                pdhg=pdhg.PDHGOptions(tol=1e-7))
        hub = {"hub_class": PHHub,
               "hub_kwargs": {"options": {
                   "rel_gap": REL_GAP, "checkpoint_path": ckpt,
                   "checkpoint_every_s": 1e9}},  # emergency save only
               "opt_class": fw.FusedPH,
               "opt_kwargs": {"options": opts, "batch": b,
                              "wheel_options": _WOPTS}}
        return WheelSpinner(hub, _SPOKES)
    return build


def _bracket(ws):
    inner, outer = float(ws.BestInnerBound), float(ws.BestOuterBound)
    assert np.isfinite(inner) and np.isfinite(outer)
    gap = (inner - outer) / max(abs(inner), abs(outer), 1e-12)
    return inner, outer, gap


def _storm(tmp_path, seed, kill_iter=3, host=1):
    prog = farmer.scenario_program(S, seed=seed)

    # A side: fault-free wheel on the full 8-device mesh
    base = _build_fn(prog, str(tmp_path / f"base{seed}.npz"))(
        mesh_mod.make_mesh(devices=SLOTS))
    base.spin()
    ib, ob, gb = _bracket(base)
    assert gb <= REL_GAP + 1e-6
    kill_iter = min(kill_iter, max(1, base.spcomm._iter - 1))

    # B side: same program, but a host dies mid-wheel
    cap = _Cap()
    bus = EventBus()
    bus.subscribe(cap)
    trace_file = str(tmp_path / f"mesh_trace{seed}.jsonl")
    bus.subscribe(tel.JsonlSink(trace_file))
    ckpt = str(tmp_path / f"storm{seed}.npz")
    before = _metrics.REGISTRY.get("mesh_reshards_total")
    before_lost = _metrics.REGISTRY.get("mesh_reshards_lost_total")
    plan = FaultPlan(seed=seed, meshes=(
        MeshFault("host_lost", host=host, at_iters=(kill_iter,)),))
    ws, info = run_elastic(_build_fn(prog, ckpt),
                           num_hosts=NUM_HOSTS, checkpoint_path=ckpt,
                           plan=plan, bus=bus, run_id=f"storm{seed}",
                           devices=SLOTS)

    assert info["resumed"] and len(info["reshards"]) == 1
    r = info["reshards"][0]
    assert r["reason"] == "host-lost"
    assert (r["old_devices"], r["new_devices"]) == (8, 6)
    assert info["final_devices"] == 6 and info["epoch"] >= 1
    assert _metrics.REGISTRY.get("mesh_reshards_total") == before + 1
    assert _metrics.REGISTRY.get("mesh_reshards_lost_total") \
        == before_lost
    assert tel.MESH_HOST_LOST in cap.kinds()
    assert tel.MESH_RESHARD in cap.kinds()
    resh = [e for e in cap.events if e.kind == tel.MESH_RESHARD][0]
    assert resh.data["new_devices"] == 6
    assert resh.data["scenarios"] == S

    # the resumed run holds the SAME certified bracket: both sides'
    # outer bounds stay below both sides' inner bounds (they bracket
    # one EF objective), and the chaos side certifies the gap target
    ic, oc, gc = _bracket(ws)
    assert gc <= REL_GAP + 1e-6
    slack = REL_GAP * max(abs(ib), abs(ic))
    assert ob <= ic + slack and oc <= ib + slack

    # trace continuity: the kill, the reshard
    # and the resumed attempt are ONE causal tree — the pre-kill and
    # post-reshard segments share the trace, the reshard span sits on
    # the critical path, and no span is orphaned by the host loss
    from mpisppy_tpu_torch.telemetry import spans
    trep = spans.assemble_path(trace_file)
    assert trep["orphans"] == [], trep["orphans"]
    names = [sp["name"] for sp in trep["spans"]]
    assert names[0] == "mesh-run", names
    assert names.count("mesh-segment") == 2, names
    assert "reshard" in names, names
    assert trep["migrated_segments"] == 1
    assert trep["critical_path"]["buckets"].get(
        "migration-gap", 0) > 0, trep["critical_path"]
    return info


@pytest.mark.parametrize("seed", [0, 1])
def test_mesh_chaos_storm(tmp_path, seed):
    _storm(tmp_path, seed)
