# Port parity: the ccopf model (mpisppy_tpu_torch/models/ccopf.py) and the
# ccopf --soc workload — the branch-flow SOCP relaxation of AC power flow
# on a 3-stage tree — against the JAX package, on the CPU.
#
# * the scenario builders give the same specs (DC and SOC, with and
#   without a rolling-horizon step), soc_blocks included;
# * pdhg.solve on the SOC batch: the same statuses, objectives within
#   1e-4 relative (both f32; the port's shared-A windows take the window
#   kernel's hoisted form, the JAX solver its plain iteration);
# * the slice as a whole: the port's fused wheel (PH hub, fused
#   Lagrangian and x̂-x̄ spokes) on (3,3), both dispatch paths, against the
#   JAX fused wheel on the same batch — a certified gap
#   of at most 1%, bounds within 1e-3 relative, one best_nonants row per
#   tree node, and the hub's final duals in the polar cone to 1e-6
#   (mirrors tests/test_cones.py::test_ccopf_soc_wheel_end_to_end).
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
from mpisppy_tpu.models import ccopf as jccopf
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.cylinders.hub import PHHub as TPHHub
from mpisppy_tpu_torch.models import ccopf as tccopf
from mpisppy_tpu_torch.ops import cones as tcones
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner

torch.set_num_threads(1)

BFS = (3, 3)


def _specs(mod, bfs=BFS, **kw):
    return [mod.scenario_creator(nm, branching_factors=bfs, **kw)
            for nm in mod.scenario_names_creator(bfs[0] * bfs[1])]


@pytest.mark.parametrize("soc", [False, True], ids=["dc", "soc"])
@pytest.mark.parametrize("mpc_step", [-1, 5])
def test_specs_match_jax(soc, mpc_step):
    for js, ts in zip(_specs(jccopf, soc=soc, mpc_step=mpc_step),
                      _specs(tccopf, soc=soc, mpc_step=mpc_step)):
        assert ts.name == js.name
        for f in ("c", "q", "A", "bl", "bu", "l", "u", "nonant_idx"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                          err_msg=f)
        if soc:
            assert len(ts.soc_blocks) == len(js.soc_blocks) == 9
            for tb, jb in zip(ts.soc_blocks, js.soc_blocks):
                np.testing.assert_array_equal(tb, jb)
        else:
            assert ts.soc_blocks is None and js.soc_blocks is None


def test_feeder_shapes_and_instances_match_jax():
    spec = tccopf.scenario_creator("scen0", soc=True)
    assert spec.A.shape == (69, 81) and len(spec.nonant_idx) == 6
    wide = tccopf.scenario_creator(
        "scen0", instance=tccopf.feeder_instance(n_buses=33), soc=True)
    assert wide.A.shape == (678, 777) and len(wide.soc_blocks) == 96
    for fn in ("grid_instance", "feeder_instance"):
        t, j = getattr(tccopf, fn)(), getattr(jccopf, fn)()
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
    np.testing.assert_array_equal(tccopf.mpc_drift(np.ones(4), 7),
                                  jccopf.mpc_drift(np.ones(4), 7))
    assert tccopf.branch_multiplier(2, 5) == jccopf.branch_multiplier(2, 5)
    with pytest.raises(ValueError, match="3-stage"):
        tccopf.scenario_creator("scen0", branching_factors=(3, 3, 3))


@pytest.mark.parametrize("bfs", [(3, 3), (100, 100)])
def test_make_tree_matches_jax(bfs):
    t, j = tccopf.make_tree(bfs), jccopf.make_tree(bfs)
    assert (t.branching_factors, t.nonants_per_stage) == (
        j.branching_factors, j.nonants_per_stage)
    assert t.num_nodes == j.num_nodes == 1 + bfs[0]
    np.testing.assert_array_equal(t.node_of_slot(), j.node_of_slot())
    assert tccopf.scenario_names_creator(3, start=2) == \
        jccopf.scenario_names_creator(3, start=2)


@pytest.fixture(scope="module")
def soc_batch():
    return jbatch.from_specs(_specs(jccopf, soc=True),
                             tree=jccopf.make_tree(BFS))


def test_pdhg_solve_on_the_soc_batch_matches_jax(soc_batch):
    jb = soc_batch
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    assert tb.qp.cones is not None
    jopts = jpdhg.PDHGOptions(tol=1e-6, max_iters=4000)
    topts = tpdhg.PDHGOptions(tol=1e-6, max_iters=4000)
    jst = jpdhg.solve(jb.qp, jopts, jpdhg.init_state(jb.qp, jopts))
    tst = tpdhg.solve(tb.qp, topts, tpdhg.init_state(tb.qp, topts))
    np.testing.assert_array_equal(tst.status.numpy(), np.asarray(jst.status))
    assert np.all(tst.status.numpy() == tpdhg.OPTIMAL)
    jobj = np.asarray(jb.objective(jst.x))
    tobj = tb.objective(tst.x).numpy()
    np.testing.assert_allclose(tobj, jobj, rtol=1e-4)
    dcr = tcones.dual_cone_residual_rows(tb.qp.cones, tst.y)
    assert float(dcr.max()) <= 1e-6


def _wheel(ph_mod, pdhg_mod, fw_mod, spoke_mod, hub_cls, spinner, batch,
           split):
    """tests/test_cones.py's options (rho 10, tol 1e-6) on the fused
    wheel, 1% gap, at most 80 iterations."""
    opts = ph_mod.PHOptions(default_rho=10.0, max_iterations=80,
                            conv_thresh=0.0,
                            pdhg=pdhg_mod.PDHGOptions(tol=1e-6))
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
def jax_wheel_bounds(soc_batch):
    jws = _wheel(jph, jpdhg, jfw, jspoke, JPHHub, JWheelSpinner, soc_batch,
                 None)
    return jws.BestOuterBound, jws.BestInnerBound


@pytest.mark.parametrize("split", [True, False])
def test_ccopf_soc_fused_wheel_matches_jax(split, soc_batch,
                                           jax_wheel_bounds):
    tb = convert.batch_from_arrays(convert.arrays_of(soc_batch), "cpu")
    assert tb.qp.cones is not None
    tws = _wheel(tph, tpdhg, tfw, tspoke, TPHHub, TWheelSpinner, tb, split)
    outer, inner = tws.BestOuterBound, tws.BestInnerBound
    assert np.isfinite(outer) and np.isfinite(inner)
    assert outer <= inner
    assert tws.spcomm.compute_gaps()[1] <= 1e-2
    for t, j in zip((outer, inner), jax_wheel_bounds):
        assert abs(t - j) <= 1e-3 * abs(j), (t, j)
    # the three-stage tree: one incumbent row per tree node (ROOT + 3)
    assert tws.spcomm.best_nonants().shape == (tb.tree.num_nodes,
                                               tb.num_nonants) == (4, 6)
    y = tws.spcomm.opt.state.solver.y
    dcr = tcones.dual_cone_residual_rows(tws.spcomm.opt.batch.qp.cones, y)
    assert float(dcr.max()) <= 1e-6
