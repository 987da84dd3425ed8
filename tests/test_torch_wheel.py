# Port parity: the fused PH wheel end to end — the mirror of
# tests/test_fused_wheel.py.  WheelSpinner(hub_dict, spokes).spin() runs
# a PH hub with fused spokes:
#   * sslp(5,15) at S=16 with the Lagrangian and x̂-x̄ spokes, once per
#     dispatch path, in both packages from the same batch: the port
#     certifies rel_gap <= 1% and its bounds lie
#     within 1e-3 relative of the JAX wheel's (both f32; the port's
#     shared-A windows take the kernel's hoisted form);
#   * farmer at S=3 with all four fused spokes (per-scenario A, the plain
#     batched iteration) in both packages: both brackets hold the EF
#     value at 2e-3 and certify 0.5%;
#   * the slam and shuffle planes publish through the packed scalars,
#     and split dispatch agrees with the monolithic step at the JAX
#     test's tolerances (1e-3 outer, 5e-3 inner).
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.cylinders.hub import PHHub as TPHHub
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.ops import pdhg_window
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner

torch.set_num_threads(1)


def _wheel(ph_mod, pdhg_mod, fw_mod, spoke_mod, hub_cls, spinner, batch,
           split):
    opts = ph_mod.PHOptions(default_rho=20.0, max_iterations=200,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg_mod.PDHGOptions(tol=1e-7))
    hub = {"hub_class": hub_cls,
           "hub_kwargs": {"options": {"rel_gap": 1e-2}},
           "opt_class": fw_mod.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw_mod.FusedWheelOptions(
                              split_dispatch=split)}}
    spokes = [{"spoke_class": spoke_mod.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke_mod.FusedXhatXbarInnerBound,
               "opt_kwargs": {"options": {}}}]
    return spinner(hub, spokes).spin()


@pytest.fixture(scope="module")
def sslp16():
    """The sslp(5,15) S=16 batch and the JAX wheel's bounds on it (the
    JAX package's own dispatch choice at S=16: one fused program; its
    split path agrees with it to ~1e-4 on these bounds)."""
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=16,
                                    lp_relax=True)
             for nm in jsslp.scenario_names_creator(16)]
    jb = jbatch.from_specs(specs)
    jws = _wheel(jph, jpdhg, jfw, jspoke, JPHHub, JWheelSpinner, jb, None)
    return jb, (jws.BestOuterBound, jws.BestInnerBound)


@pytest.mark.parametrize("split", [True, False])
def test_sslp_fused_wheel_matches_jax(split, sslp16):
    jb, jbounds = sslp16
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    tws = _wheel(tph, tpdhg, tfw, tspoke, TPHHub, TWheelSpinner, tb, split)
    outer, inner = tws.BestOuterBound, tws.BestInnerBound
    assert np.isfinite(inner) and np.isfinite(outer)
    assert (inner - outer) / abs(inner) <= 1e-2 + 1e-6
    assert outer <= inner
    for t, j in zip((outer, inner), jbounds):
        assert abs(t - j) <= 1e-3 * abs(j), (t, j)
    # the incumbent's solution is retrievable, one row per tree node
    assert tws.spcomm.best_nonants().shape == (1, tb.num_nonants)
    assert len(tws.spcomm.trace) == tws.spcomm._iter


def test_wheel_never_launches_the_kernel_on_cpu_tensors():
    """On the CPU the wrapper takes the plain version: the kernel's
    launch count does not move."""
    inst = tsslp.synthetic_instance(5, 15, seed=0)
    specs = [tsslp.scenario_creator(nm, instance=inst, num_scens=4,
                                    lp_relax=True)
             for nm in tsslp.scenario_names_creator(4)]
    tb = tbatch.from_specs(specs, device="cpu")
    before = dict(pdhg_window.run_window.launches)
    opts = tph.PHOptions(default_rho=20.0, max_iterations=2,
                         conv_thresh=0.0, iter0_windows=4)
    hub = {"hub_class": TPHHub, "hub_kwargs": {"options": {"rel_gap": 1e-2}},
           "opt_class": tfw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": tb}}
    ws = TWheelSpinner(hub, [
        {"spoke_class": tspoke.FusedLagrangianOuterBound,
         "opt_kwargs": {"options": {}}}]).spin()
    assert ws.spcomm._iter == 3  # the sync after Iter0, then two
    assert dict(pdhg_window.run_window.launches) == before


def _all_fused_spokes(spoke_mod):
    return [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        spoke_mod.FusedLagrangianOuterBound,
        spoke_mod.FusedXhatXbarInnerBound,
        spoke_mod.FusedXhatShuffleInnerBound,
        spoke_mod.FusedSlamHeuristic)]


def test_slam_and_shuffle_planes_run_and_publish():
    """The slam and shuffle planes run inside the hub's step, pack their
    values into the one scalar transfer (10 keys, the JAX package's
    layout) and the fused spokes publish them with their candidates."""
    specs = [tsslp.scenario_creator(nm, n_servers=3, n_clients=4,
                                    num_scens=4, lp_relax=True)
             for nm in tsslp.scenario_names_creator(4)]
    tb = tbatch.from_specs(specs, device="cpu")
    assert tfw.SCALAR_KEYS == jfw.SCALAR_KEYS
    opts = tph.PHOptions(default_rho=20.0, max_iterations=6,
                         conv_thresh=0.0, iter0_windows=20)
    for split in (True, False):
        wopts = tfw.FusedWheelOptions(lag_windows=0, xhat_windows=0,
                                      slam_windows=2, shuffle_windows=2,
                                      split_dispatch=split)
        hub = {"hub_class": TPHHub,
               "hub_kwargs": {"options": {"rel_gap": 1e-9}},
               "opt_class": tfw.FusedPH,
               "opt_kwargs": {"options": opts, "batch": tb,
                              "wheel_options": wopts}}
        spokes = _all_fused_spokes(tspoke)[2:]
        ws = TWheelSpinner(hub, spokes).spin()
        opt = ws.spcomm.opt
        assert set(opt.scalar_cache) == set(jfw.SCALAR_KEYS)
        assert opt.wstate.scalars.shape == (10,)
        for sp, plane in zip(ws.spcomm.spokes, ("shuf", "slam")):
            assert sp.bound is not None and np.isfinite(sp.bound)
            assert sp.best_xhat.shape == (tb.num_nonants,)
            assert opt.cand_cache[plane].shape == (tb.num_nonants,)
        assert np.isfinite(ws.BestInnerBound)


FARMER_EF_OBJ = -108390.0


def _farmer_wheel(ph_mod, pdhg_mod, fw_mod, spoke_mod, hub_cls, spinner,
                  batch, wopts_kw=None, split=None):
    """tests/test_fused_wheel.py::test_fused_wheel_farmer_certified_gap's
    wheel: all four fused spokes, slam to the scenario min."""
    wopts = fw_mod.FusedWheelOptions(
        slam_windows=2, shuffle_windows=4, slam_sense_max=False,
        split_dispatch=split,
        lag_pdhg=pdhg_mod.PDHGOptions(tol=1e-7),
        xhat_pdhg=pdhg_mod.PDHGOptions(tol=1e-7, omega0=0.1,
                                       restart_period=80))
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=150,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg_mod.PDHGOptions(tol=1e-7))
    hub = {"hub_class": hub_cls,
           "hub_kwargs": {"options": {"rel_gap": 5e-3}},
           "opt_class": fw_mod.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": wopts}}
    return spinner(hub, _all_fused_spokes(spoke_mod)).spin()


def test_farmer_fused_wheel_matches_jax():
    """The farmer fused wheel with all four fused spokes (per-scenario A:
    every window runs the plain batched iteration) in both packages from
    the same S=3 batch.  Both brackets hold the EF value -108390 at the
    JAX test's slack (2e-3 relative) and certify 0.5%.  Iteration counts
    are not compared: done flags flip where restart scores sit at the
    f32 floor (ROADMAP C1)."""
    from mpisppy_tpu.models import farmer as jfarmer
    jb = jbatch.from_specs([jfarmer.scenario_creator(nm, num_scens=3)
                            for nm in jfarmer.scenario_names_creator(3)])
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    assert tb.qp.A.ndim == 3
    before = dict(pdhg_window.run_window.launches)
    jws = _farmer_wheel(jph, jpdhg, jfw, jspoke, JPHHub, JWheelSpinner, jb)
    tws = _farmer_wheel(tph, tpdhg, tfw, tspoke, TPHHub, TWheelSpinner, tb)
    assert dict(pdhg_window.run_window.launches) == before
    slack = 2e-3 * abs(FARMER_EF_OBJ)
    for ws in (jws, tws):
        inner, outer = ws.BestInnerBound, ws.BestOuterBound
        assert np.isfinite(inner) and np.isfinite(outer)
        assert outer <= inner + 2e-3 * abs(inner)
        assert outer <= FARMER_EF_OBJ + slack
        assert inner >= FARMER_EF_OBJ - slack
        assert (inner - outer) / abs(inner) <= 5e-3 + 1e-6
        assert ws.spcomm._iter < 150
    assert tws.spcomm.best_nonants().shape[1] == tb.num_nonants


def test_split_dispatch_matches_monolithic():
    """The port's mirror of tests/test_fused_wheel.py's test, at its
    tolerances: split dispatch and the monolithic step run the same plane
    math, so the Lagrangian bound agrees to 1e-3 and the inner bound to
    5e-3 (split mode freezes the x̄ candidate across exchanges), and
    both brackets are consistent."""
    inst = tsslp.synthetic_instance(5, 15, seed=0)
    specs = [tsslp.scenario_creator(nm, instance=inst, num_scens=16,
                                    lp_relax=True)
             for nm in tsslp.scenario_names_creator(16)]
    tb = tbatch.from_specs(specs, device="cpu")
    results = {}
    for split in (True, False):
        wopts = tfw.FusedWheelOptions(split_dispatch=split,
                                      adapt_budgets=False,
                                      slam_windows=2, shuffle_windows=2)
        opts = tph.PHOptions(default_rho=20.0, max_iterations=60,
                             conv_thresh=0.0, subproblem_windows=10,
                             pdhg=tpdhg.PDHGOptions(tol=1e-7))
        hub = {"hub_class": TPHHub,
               "hub_kwargs": {"options": {"rel_gap": 1e-2}},
               "opt_class": tfw.FusedPH,
               "opt_kwargs": {"options": opts, "batch": tb,
                              "wheel_options": wopts}}
        ws = TWheelSpinner(hub, _all_fused_spokes(tspoke)).spin()
        results[split] = (ws.BestOuterBound, ws.BestInnerBound)
    (o1, i1), (o2, i2) = results[True], results[False]
    assert np.isfinite(o1) and np.isfinite(i1)
    assert abs(o1 - o2) <= 1e-3 * max(1.0, abs(o2))
    assert abs(i1 - i2) <= 5e-3 * max(1.0, abs(i2))
    for outer, inner in results.values():
        assert outer <= inner + 1e-6 * max(1.0, abs(inner))


def test_tail_rescue_gathers_a_per_scenario_a():
    """The straggler tail on farmer's (S, m, n) A: _gather_qp takes the
    worst scenarios' own matrices, and the rescued sub-solve is written
    back into exactly those rows (the others stay bit-unchanged)."""
    from mpisppy_tpu_torch.models import farmer as tfarmer
    S = 24
    tb = tbatch.from_specs([tfarmer.scenario_creator(nm, num_scens=S)
                            for nm in tfarmer.scenario_names_creator(S)],
                           device="cpu")
    qp = tb.qp
    idx = torch.tensor([5, 17, 2])
    sub = tfw._gather_qp(qp, idx)
    assert torch.equal(sub.A, qp.A[idx]) and torch.equal(sub.c, qp.c[idx])
    wopts = tfw.FusedWheelOptions(xhat_tail_k=8, xhat_tail_windows=2)
    st = tpdhg.init_state(qp, wopts.xhat_pdhg)
    rp = torch.linspace(1.0, 2.0, S)       # every scenario misses the gate
    out = tfw._tail_rescue(qp, st, rp, tb.p > 0, wopts, 1e-3)
    moved = (out.x != st.x).any(dim=-1)
    assert moved[-8:].all() and not moved[:-8].any()
