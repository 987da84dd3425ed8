# Port parity: wheel checkpoints (cylinders/hub.py, utils/wxbarutils.py)
# against the JAX package's, in both directions:
#   * the port's state_template() leaves equal jax.tree.flatten of the JAX
#     driver's state_template() in count, order, shape and dtype — PH on
#     farmer S=3 and the fused wheel (all four planes) on sslp 5x15 S=16,
#     each with kernel counters off and on — and equal the leaves of the
#     port's real Iter0 state;
#   * an APH snapshot does not restore in the JAX package (its APH
#     inherits PH's template); the port's restores and resumes the
#     uninterrupted rows (ROADMAP.md C1);
#   * a snapshot the JAX hub writes after k iterations loads into the
#     port's hub: every restored leaf equals convert.py's copy of the
#     state the JAX hub restores from the same file, exactly, and so do
#     the hub's iteration counters, bounds and spoke bests; the JAX hub
#     (its own code) loads the port's snapshot the same way (the port's
#     carries the JAX keys, plus extras the JAX hub ignores);
#   * _checkpoint_crc agrees across packages on the same arrays, and
#     save_ph_state / load_ph_state files load in either package;
#   * from one JAX-written fused-wheel snapshot both packages resume 5
#     hub iterations and their trace rows' bounds agree to 1e-3 relative
#     (tests/test_torch_wheel.py's tolerance for this wheel).

import jax
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import aph as japh
from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.resilience import faults as jfaults
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import aph as taph
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.cylinders import hub as thub
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.resilience import faults as tfaults
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner
from mpisppy_tpu_torch.utils import wxbarutils as wx

torch.set_num_threads(1)

PKG = {"jax": (jph, jpdhg, jfw, jspoke, jhub, JWheelSpinner, jfaults),
       "torch": (tph, tpdhg, tfw, tspoke, thub, TWheelSpinner, tfaults)}
PREEMPT_AT = 4        # the hub iteration the fault plan preempts at
RESUME_ITERS = 5      # hub iterations both packages resume
RESUME_RTOL = 1e-3    # tests/test_torch_wheel.py's sslp 5x15 tolerance


@pytest.fixture(scope="module")
def farmer():
    jb = jbatch.from_specs([jfarmer.scenario_creator(nm, num_scens=3)
                            for nm in jfarmer.scenario_names_creator(3)])
    return {"jax": jb,
            "torch": convert.batch_from_arrays(convert.arrays_of(jb), "cpu")}


@pytest.fixture(scope="module")
def sslp():
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    jb = jbatch.from_specs([
        jsslp.scenario_creator(nm, instance=inst, num_scens=16,
                               lp_relax=True)
        for nm in jsslp.scenario_names_creator(16)])
    return {"jax": jb,
            "torch": convert.batch_from_arrays(convert.arrays_of(jb), "cpu")}


def ph_options(pkg, telemetry, max_iterations=60, iter0_windows=400):
    ph_mod, pdhg = PKG[pkg][:2]
    return ph_mod.PHOptions(
        default_rho=1.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=10, iter0_windows=iter0_windows,
        pdhg=pdhg.PDHGOptions(tol=1e-7, telemetry=telemetry))


def ph_wheel(pkg, batch, telemetry, hub_extra, max_iterations=60):
    """The chaos tests' farmer wheel: a PH hub with the classic
    Lagrangian and x̂-x̄ spokes."""
    ph_mod, _, _, sm, hm, spinner, _ = PKG[pkg]
    hub = {"hub_class": hm.PHHub,
           "hub_kwargs": {"options": {"rel_gap": 5e-3, **hub_extra}},
           "opt_class": ph_mod.PH,
           "opt_kwargs": {"options": ph_options(pkg, telemetry,
                                                max_iterations),
                          "batch": batch}}
    spokes = [{"spoke_class": c, "opt_kwargs": {"options": {}}}
              for c in (sm.LagrangianOuterBound, sm.XhatXbarInnerBound)]
    return spinner(hub, spokes)


def fused_wheel(pkg, batch, hub_extra, max_iterations=60):
    """tests/test_torch_wheel.py's sslp 5x15 wheel (rho 20) with all four
    fused planes."""
    ph_mod, pdhg, fw, sm, hm, spinner, _ = PKG[pkg]
    opts = ph_mod.PHOptions(default_rho=20.0, max_iterations=max_iterations,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg.PDHGOptions(tol=1e-7))
    hub = {"hub_class": hm.PHHub,
           "hub_kwargs": {"options": {"rel_gap": 1e-2, **hub_extra}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions(
                              slam_windows=2, shuffle_windows=4)}}
    spokes = [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        sm.FusedLagrangianOuterBound, sm.FusedXhatXbarInnerBound,
        sm.FusedXhatShuffleInnerBound, sm.FusedSlamHeuristic)]
    return spinner(hub, spokes)


def preempted_snapshot(pkg, make, path):
    """Spin a wheel under a fault plan that preempts it at PREEMPT_AT;
    the spinner's emergency save writes `path`."""
    plan = PKG[pkg][6].FaultPlan(seed=3, preempt_at_iter=PREEMPT_AT)
    ws = make({"checkpoint_path": path, "checkpoint_every_s": 1e9,
               "fault_plan": plan})
    with pytest.raises(PKG[pkg][6].PreemptionError):
        ws.spin()
    assert ws.preempted
    return ws


def jax_specs(state):
    return [(tuple(a.shape), np.dtype(a.dtype))
            for a in jax.tree.flatten(state)[0]]


def port_specs(state):
    return [(s.shape, s.dtype) for s in wx.leaf_specs(state)]


def jax_leaves(state):
    return [np.asarray(a) for a in jax.tree.flatten(state)[0]]


def port_leaves(state):
    return [wx.leaf_array(a) for a in wx.state_leaves(state)]


def assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# leaf format
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("telemetry", [False, True])
def test_ph_template_leaves_match_jax(farmer, telemetry):
    jt = jph.PH(ph_options("jax", telemetry), farmer["jax"]).state_template()
    t = tph.PH(ph_options("torch", telemetry), farmer["torch"])
    tt = t.state_template()
    assert port_specs(tt) == jax_specs(jt)
    assert len(jax_specs(jt)) == (27 if telemetry else 22)
    # the template is the real Iter0 state's structure
    st, _, _ = tph.ph_iter0(t.batch, t.rho,
                            ph_options("torch", telemetry, iter0_windows=2))
    assert port_specs(st) == port_specs(tt)
    assert (st.solver.counters is None) != telemetry


@pytest.mark.parametrize("telemetry", [False, True])
def test_fused_template_leaves_match_jax(sslp, telemetry):
    wopts = {pkg: PKG[pkg][2].FusedWheelOptions(slam_windows=2,
                                                 shuffle_windows=4)
             for pkg in PKG}
    jt = jfw.FusedPH(ph_options("jax", telemetry), sslp["jax"],
                     wopts["jax"]).state_template()
    t = tfw.FusedPH(ph_options("torch", telemetry), sslp["torch"],
                    wopts["torch"])
    tt = t.state_template()
    assert port_specs(tt) == jax_specs(jt)
    assert len(jax_specs(jt)) == (120 if telemetry else 95)
    st, _, _ = tfw.fused_iter0(
        t.batch, t.rho, ph_options("torch", telemetry, iter0_windows=2),
        wopts["torch"])
    assert port_specs(st) == port_specs(tt)


def test_aph_snapshot_restores_in_neither_package(farmer, tmp_path):
    """APH defines no template of its own in the JAX package: it inherits
    PH's, which is a PHState while APH's state is an APHState, so the JAX
    hub's restore of an APH snapshot raises (ph_iter0 reads PHOptions
    fields APHOptions lacks).  The port builds its template from
    aph_iter0's shapes (ROADMAP.md C1, formerly C5): its APH hub
    preempted at hub iteration k restores the snapshot and continues the
    uninterrupted run's trace rows exactly."""
    path = str(tmp_path / "aph.npz")
    spinners = {}
    for pkg, aph_mod in (("jax", japh), ("torch", taph)):
        _, pdhg, _, sm, hm, spinner, faults = PKG[pkg]
        opts = aph_mod.APHOptions(max_iterations=6, conv_thresh=0.0,
                                  iter0_windows=20,
                                  pdhg=pdhg.PDHGOptions(tol=1e-7))
        spinners[pkg] = lambda extra=None, hm=hm, aph_mod=aph_mod, \
            opts=opts, spinner=spinner, pkg=pkg: spinner(
                {"hub_class": hm.APHHub,
                 "hub_kwargs": {"options": {
                     "rel_gap": 1e-9, "checkpoint_path": path,
                     "checkpoint_every_s": 1e9, **(extra or {})}},
                 "opt_class": aph_mod.APH,
                 "opt_kwargs": {"options": opts, "batch": farmer[pkg]}},
                [])
    ws0 = spinners["torch"]().spin()
    plan = tfaults.FaultPlan(seed=0, preempt_at_iter=3)
    with pytest.raises(tfaults.SimulatedPreemption):
        spinners["torch"]({"fault_plan": plan}).spin()
    with np.load(path) as d:
        assert bytes(d["which"]).decode() == "state"
    with pytest.raises(AttributeError, match="smooth_beta"):
        spinners["jax"]().build().spcomm.load_checkpoint(path)
    ws1 = spinners["torch"]().build()
    ws1.spcomm.load_checkpoint(path)
    assert ws1.spcomm._iter == 3
    ws1.spin()

    def rows(ws):
        return [{k: v for k, v in r.items() if k != "t"}
                for r in ws.spcomm.trace]
    assert rows(ws1) == rows(ws0)[3:]
    assert (ws1.BestOuterBound, ws1.BestInnerBound) \
        == (ws0.BestOuterBound, ws0.BestInnerBound)
    assert ws1.opt._iter == ws0.opt._iter


# ---------------------------------------------------------------------------
# interchange
# ---------------------------------------------------------------------------
def test_jax_ph_snapshot_restores_in_the_port(farmer, tmp_path):
    """PH with kernel counters and the lane guard's counts: the JAX hub
    writes, both hubs restore, the states and bookkeeping are equal."""
    path = str(tmp_path / "jax.npz")
    preempted_snapshot("jax", lambda extra: ph_wheel(
        "jax", farmer["jax"], True, extra), path)
    jws = ph_wheel("jax", farmer["jax"], True,
                   {"checkpoint_path": path}).build()
    jws.spcomm.load_checkpoint(path)
    tws = ph_wheel("torch", farmer["torch"], True,
                   {"checkpoint_path": path}).build()
    tws.spcomm.load_checkpoint(path)
    want = convert.ph_state_from_arrays(convert.arrays_of(jws.opt.state),
                                        "cpu")
    assert_leaves_equal(port_leaves(tws.opt.state), port_leaves(want))
    assert tws.opt.state.solver.counters is not None
    assert tws.opt.state.solver.counters.ring_pos > 0
    th, jh = tws.spcomm, jws.spcomm
    assert th._iter == jh._iter == PREEMPT_AT
    assert tws.opt._iter == jws.opt._iter == PREEMPT_AT - 1
    assert (th.BestOuterBound, th.BestInnerBound) \
        == (jh.BestOuterBound, jh.BestInnerBound)
    assert th._inner_bound_update_iter == jh._inner_bound_update_iter
    assert tws.opt.trivial_bound == jws.opt.trivial_bound
    for ts, js in zip(th.spokes, jh.spokes):
        assert ts.bound == js.bound
    np.testing.assert_array_equal(th.spokes[1].best_xhat,
                                  np.asarray(jh.spokes[1].best_xhat))


def test_port_ph_snapshot_restores_in_jax(farmer, tmp_path):
    path = str(tmp_path / "torch.npz")
    ws = preempted_snapshot("torch", lambda extra: ph_wheel(
        "torch", farmer["torch"], True, extra), path)
    jws = ph_wheel("jax", farmer["jax"], True,
                   {"checkpoint_path": path}).build()
    jws.spcomm.load_checkpoint(path)
    assert_leaves_equal(jax_leaves(jws.opt.state), port_leaves(ws.opt.state))
    assert jws.spcomm._iter == ws.spcomm._iter == PREEMPT_AT
    assert (jws.BestOuterBound, jws.BestInnerBound) \
        == (ws.BestOuterBound, ws.BestInnerBound)


@pytest.fixture(scope="module")
def jax_fused_snapshot(sslp, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fused") / "jax_fused.npz")
    preempted_snapshot("jax", lambda extra: fused_wheel(
        "jax", sslp["jax"], extra), path)
    return path


def test_fused_snapshots_interchange(sslp, jax_fused_snapshot, tmp_path):
    """The whole wheel state (hub and four planes): the JAX snapshot
    restores in the port with every leaf equal to the JAX restore's, and
    the port's restores in the JAX hub the same way."""
    path = jax_fused_snapshot
    jws = fused_wheel("jax", sslp["jax"], {"checkpoint_path": path}).build()
    jws.spcomm.load_checkpoint(path)
    tws = fused_wheel("torch", sslp["torch"],
                      {"checkpoint_path": path}).build()
    tws.spcomm.load_checkpoint(path)
    assert_leaves_equal(port_leaves(tws.opt.wstate),
                        jax_leaves(jws.opt.wstate))
    assert tws.opt.state is tws.opt.wstate.ph
    # and back: the port writes the state it restored, JAX reads it
    back = str(tmp_path / "back.npz")
    assert tws.spcomm.save_checkpoint(back)
    jws2 = fused_wheel("jax", sslp["jax"], {"checkpoint_path": back}).build()
    jws2.spcomm.load_checkpoint(back)
    assert_leaves_equal(jax_leaves(jws2.opt.wstate),
                        jax_leaves(jws.opt.wstate))
    # the JAX snapshot's keys with their dtypes and shapes; the port adds
    # only extras (the fused wheel's host cycle, which the JAX hub
    # returns to its caller and ignores)
    with np.load(path) as a, np.load(back) as b:
        assert set(a.files) <= set(b.files)
        assert all(k.startswith("extra_") for k in set(b.files) - set(a.files))
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_ph_state_files_interchange(farmer, tmp_path):
    """utils/wxbarutils.save_ph_state / load_ph_state: the port's file
    loads in the JAX package and back, leaf for leaf."""
    from mpisppy_tpu.utils import wxbarutils as jwx
    t = tph.PH(ph_options("torch", True, iter0_windows=4), farmer["torch"])
    t.state, _, _ = tph.ph_iter0(t.batch, t.rho, t.options)
    t._iter = 3
    j = jph.PH(ph_options("jax", True, iter0_windows=4), farmer["jax"])
    j.state, _, _ = jph.ph_iter0(j.batch, j.rho,
                                 jph.kernel_opts(j.options))
    path = str(tmp_path / "ph.npz")
    wx.save_ph_state(path, t)
    jwx.load_ph_state(path, j)
    assert j._iter == 3
    assert_leaves_equal(jax_leaves(j.state), port_leaves(t.state))
    back = str(tmp_path / "back.npz")
    jwx.save_ph_state(back, j)
    t2 = tph.PH(ph_options("torch", True), farmer["torch"])
    t2.state = t.state
    wx.load_ph_state(back, t2)
    assert t2._iter == 3
    assert_leaves_equal(port_leaves(t2.state), port_leaves(t.state))
    assert t2.state.solver.k == t.state.solver.k


def test_checkpoint_crc_agrees_across_packages():
    rng = np.random.default_rng(0)
    data = {"which": np.frombuffer(b"wstate", np.uint8),
            "hub_iter": np.asarray(7), "bounds": rng.normal(size=2),
            "leaf0": rng.normal(size=(16, 5)).astype(np.float32),
            "leaf1": rng.random(16) > 0.5,
            "leaf2": np.asarray(40, np.int32)}
    want = jhub._checkpoint_crc(data)
    got = thub._checkpoint_crc(data)
    assert got.dtype == want.dtype == np.uint32
    assert int(got) == int(want)
    data["leaf0"] = data["leaf0"].copy()
    data["leaf0"][3, 2] += 1.0
    assert int(thub._checkpoint_crc(data)) != int(want)


def test_resume_from_a_jax_snapshot_matches_jax(sslp, jax_fused_snapshot):
    rows = {}
    for pkg in PKG:
        ws = fused_wheel(pkg, sslp[pkg],
                         {"checkpoint_path": jax_fused_snapshot},
                         max_iterations=PREEMPT_AT - 1 + RESUME_ITERS)
        ws.build()
        ws.spcomm.load_checkpoint(jax_fused_snapshot)
        ws.spcomm.options["rel_gap"] = 0.0   # run every resumed iteration
        ws.spin()
        rows[pkg] = [(r["iter"], r["outer"], r["inner"])
                     for r in ws.spcomm.trace]
    assert [r[0] for r in rows["torch"]] == [r[0] for r in rows["jax"]] \
        == list(range(PREEMPT_AT + 1, PREEMPT_AT + RESUME_ITERS + 1))
    for (_, to, ti), (_, jo, ji) in zip(rows["torch"], rows["jax"]):
        for t, j in ((to, jo), (ti, ji)):
            if np.isfinite(j):
                assert t == pytest.approx(j, rel=RESUME_RTOL)
            else:
                assert not np.isfinite(t)
