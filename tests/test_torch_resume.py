# Port parity: resuming from a checkpoint — the mirror of
# tests/test_async_wheel.py's checkpoint tests, on farmer S=3 with its
# fused wheel (the four fused spokes, FARMER_WOPTS):
#   * a fused wheel preempted at a sync and restored from its emergency
#     snapshot continues the uninterrupted run's trace rows exactly (the
#     snapshot's extras carry the host step cycle, and the restore folds
#     the preempted sync's fused harvest);
#   * staleness 0 writes the sync wheel's snapshot byte for byte, and
#     the async wheel resumes from its snapshot (its exchange plane is
#     re-seeded from the restored state).
import os

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch.algos import async_wheel as aw
from mpisppy_tpu_torch.algos import fused_wheel as fw
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.cylinders import spoke as spoke_mod
from mpisppy_tpu_torch.cylinders.hub import AsyncPHHub, PHHub
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.resilience.faults import FaultPlan, SimulatedPreemption
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    names = farmer.scenario_names_creator(3)
    return batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3) for nm in names],
        device="cpu")


def wheel_dict(batch, staleness=None, rel_gap=1e-2, max_iterations=120,
               hub_extra=None):
    """tests/test_async_wheel.py's farmer wheel: the four fused spokes,
    the sync pair or the async pair at `staleness`."""
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=max_iterations,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg.PDHGOptions(tol=1e-7))
    wopts = fw.FusedWheelOptions(
        slam_windows=2, shuffle_windows=4, slam_sense_max=False,
        lag_pdhg=pdhg.PDHGOptions(tol=1e-7),
        xhat_pdhg=pdhg.PDHGOptions(tol=1e-7, omega0=0.1, restart_period=80))
    d = {"hub_class": PHHub,
         "hub_kwargs": {"options": {"rel_gap": rel_gap,
                                    **(hub_extra or {})}},
         "opt_class": fw.FusedPH,
         "opt_kwargs": {"options": opts, "batch": batch,
                        "wheel_options": wopts}}
    if staleness is not None:
        d["hub_class"], d["opt_class"] = AsyncPHHub, aw.AsyncFusedPH
        d["opt_kwargs"]["async_options"] = aw.AsyncWheelOptions(staleness)
    return d


def fused_spokes():
    return [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        spoke_mod.FusedLagrangianOuterBound,
        spoke_mod.FusedXhatXbarInnerBound,
        spoke_mod.FusedXhatShuffleInnerBound, spoke_mod.FusedSlamHeuristic)]


@pytest.mark.parametrize("preempt_at", [4, 9])
def test_resumed_wheel_follows_the_uninterrupted_rows(batch, tmp_path,
                                                      preempt_at):
    """A fused wheel preempted at hub iteration k and restored from its
    emergency snapshot continues the uninterrupted run's trace rows
    exactly: the snapshot's extras carry the step cycle (shuffle cursor,
    x̂ freeze, budgets, the scalar pipeline, the rescue countdown) and
    the restore folds the preempted sync's fused harvest."""
    ws0 = WheelSpinner(wheel_dict(batch), fused_spokes()).spin()
    ckpt = str(tmp_path / "f.npz")
    plan = FaultPlan(seed=0, preempt_at_iter=preempt_at)
    ws1 = WheelSpinner(wheel_dict(batch, hub_extra={
        "checkpoint_path": ckpt, "checkpoint_every_s": 1e9,
        "fault_plan": plan}), fused_spokes())
    with pytest.raises(SimulatedPreemption):
        ws1.spin()
    with np.load(ckpt) as d:
        assert int(d["extra_hub_exchange_pending"]) == 1
        assert d["extra_fw_cycle"].shape == (8,)
    ws2 = WheelSpinner(wheel_dict(batch, hub_extra={
        "checkpoint_path": ckpt}), fused_spokes()).build()
    ws2.spcomm.load_checkpoint(ckpt)
    ws2.spin()

    def rows(ws):
        return [{k: v for k, v in r.items() if k != "t"}
                for r in ws.spcomm.trace]
    assert rows(ws2) == rows(ws0)[preempt_at:]
    assert (ws2.BestOuterBound, ws2.BestInnerBound) \
        == (ws0.BestOuterBound, ws0.BestInnerBound)


def test_staleness0_checkpoint_bytes_equal_the_sync_wheel(batch, tmp_path):
    ws_sync = WheelSpinner(wheel_dict(batch), fused_spokes()).spin()
    ws0 = WheelSpinner(wheel_dict(batch, staleness=0), fused_spokes()).spin()
    assert [{k: v for k, v in r.items() if k != "t"}
            for r in ws0.spcomm.trace] == \
        [{k: v for k, v in r.items() if k != "t"}
         for r in ws_sync.spcomm.trace]
    a, b = str(tmp_path / "sync.npz"), str(tmp_path / "async0.npz")
    ws_sync.spcomm.save_checkpoint(a, background=False)
    ws0.spcomm.save_checkpoint(b, background=False)
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), \
                f"checkpoint member {k!r} differs"


def test_async_checkpoint_resume(batch, tmp_path):
    """load_checkpoint skips _iter0_impl (which seeds the exchange
    plane), so the async driver re-seeds its slots from the restored
    state: a preempted --async-staleness run resumes."""
    ckpt = str(tmp_path / "aw.ckpt.npz")
    hub_extra = {"checkpoint_path": ckpt, "checkpoint_every_s": 0.0}
    ws1 = WheelSpinner(wheel_dict(batch, staleness=1, rel_gap=1e-4,
                                  max_iterations=12, hub_extra=hub_extra),
                       fused_spokes()).spin()
    assert os.path.exists(ckpt)
    it1 = ws1.spcomm._iter
    ws2 = WheelSpinner(wheel_dict(batch, staleness=1, rel_gap=1e-4,
                                  max_iterations=30, hub_extra=hub_extra),
                       fused_spokes()).build()
    ws2.spcomm.load_checkpoint(ckpt)
    assert 0 < ws2.spcomm._iter <= it1
    assert ws2.opt._plane_slots == [None, None]
    ws2.spin()
    assert ws2.spcomm._iter > it1
    assert np.isfinite(ws2.BestOuterBound)
    assert np.isfinite(ws2.BestInnerBound)
    assert ws2.BestOuterBound <= ws2.BestInnerBound + 2e-3 * abs(
        ws2.BestInnerBound)
