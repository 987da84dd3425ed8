# Port parity: tests/test_chaos.py::test_chaos_round_trip on farmer S=3
# with the JAX test's wheel (a PH hub, the classic Lagrangian and x̂-x̄
# spokes, rel_gap 5e-3) and fault plan: NaN, wrong-sense and stale spoke
# bounds and two lane faults, then a simulated preemption at hub
# iteration 7 whose emergency save restores at _iter == 7 with the lane
# guard's resets carried, and a resume whose certified bounds lie within
# 1e-2 of the fault-free run's and bracket the EF value at 2e-3.  A file
# of its own: the three classic-spoke wheels take ~100 s on one CPU
# thread.
import os

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.cylinders import spoke as spoke_mod
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.resilience.faults import (
    FaultPlan, LaneFault, SimulatedPreemption, SpokeBoundFault,
)
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner

torch.set_num_threads(1)

FARMER_EF_OBJ = -108390.0


@pytest.fixture(scope="module")
def batch():
    names = farmer.scenario_names_creator(3)
    return batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3) for nm in names],
        device="cpu")


def hub_dict(batch, hub_extra=None):
    """tests/test_chaos.py's hub_dict: a PH hub with the lane guard."""
    opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=150, conv_thresh=0.0,
        subproblem_windows=10,
        pdhg=pdhg.PDHGOptions(tol=1e-7, lane_guard=True))
    return {"hub_class": PHHub,
            "hub_kwargs": {"options": {"rel_gap": 5e-3,
                                       **(hub_extra or {})}},
            "opt_class": ph_mod.PH,
            "opt_kwargs": {"options": opts, "batch": batch}}


def both_spokes():
    return [{"spoke_class": spoke_mod.LagrangianOuterBound,
             "opt_kwargs": {"options": {}}},
            {"spoke_class": spoke_mod.XhatXbarInnerBound,
             "opt_kwargs": {"options": {}}}]


def test_chaos_round_trip(batch, tmp_path):
    ws0 = WheelSpinner(hub_dict(batch), both_spokes()).spin()
    assert np.isfinite(ws0.BestInnerBound) and np.isfinite(ws0.BestOuterBound)

    ckpt = str(tmp_path / "wheel.npz")
    plan = FaultPlan(
        seed=42,
        spoke_bounds=(
            SpokeBoundFault("nan", spoke_index=0, at_iters=(3, 4)),
            SpokeBoundFault("wrong_sense", spoke_index=1, at_iters=(4,),
                            magnitude=1e8),
            SpokeBoundFault("stale", spoke_index=1, at_iters=(5,)),
        ),
        lanes=(LaneFault(at_iter=3, lanes=(1,), mode="scale", scale=1e25),
               LaneFault(at_iter=5, lanes=(0,), mode="nan")),
        preempt_at_iter=7,
    )
    assert plan.armed
    hub_extra = {"fault_plan": plan, "checkpoint_path": ckpt,
                 "checkpoint_every_s": 1e9,  # emergency save only
                 "spoke_max_strikes": 10}
    ws1 = WheelSpinner(hub_dict(batch, hub_extra), both_spokes())
    with pytest.raises(SimulatedPreemption):
        ws1.spin()
    assert ws1.preempted
    assert os.path.exists(ckpt)
    assert {s for s, _ in plan.fired} == {"spoke_bound", "lanes",
                                          "preemption"}
    assert ws1.spcomm.spokes[0].strikes == 2   # two NaN harvests
    assert ws1.spcomm.spokes[1].strikes == 0   # wrong sense: no blame
    assert not any(sp.disabled for sp in ws1.spcomm.spokes)
    ob1, ib1 = ws1.BestOuterBound, ws1.BestInnerBound
    assert np.isfinite(ob1) and np.isfinite(ib1)
    assert ob1 <= ib1 + 5e-3 * abs(ib1)

    ws2 = WheelSpinner(hub_dict(batch, {"checkpoint_path": ckpt}),
                       both_spokes()).build()
    ws2.spcomm.load_checkpoint(ckpt)
    assert ws2.spcomm._iter == 7  # the emergency save's sync point
    # the lane guard fired on the corrupted lanes and its counts rode
    # along in the checkpoint
    assert int(ws2.opt.state.solver.guard_resets.max()) >= 1
    assert bool(torch.isfinite(ws2.opt.state.solver.x).all())
    assert ws2.spcomm._last_guard_total == \
        int(ws2.opt.state.solver.guard_resets.sum())
    ws2.spin()

    inner0, outer0 = ws0.BestInnerBound, ws0.BestOuterBound
    inner2, outer2 = ws2.BestInnerBound, ws2.BestOuterBound
    assert np.isfinite(inner2) and np.isfinite(outer2)
    assert outer2 <= inner2 + 2e-3 * abs(inner2)
    _, rel_gap = ws2.spcomm.compute_gaps()
    assert rel_gap <= 5e-3 + 1e-6                         # certified
    slack = 2e-3 * abs(FARMER_EF_OBJ)
    assert outer2 <= FARMER_EF_OBJ + slack                # valid bracket
    assert inner2 >= FARMER_EF_OBJ - slack
    assert inner2 == pytest.approx(inner0, rel=1e-2)      # matches
    assert outer2 == pytest.approx(outer0, rel=1e-2)
