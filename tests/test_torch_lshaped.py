# Port parity: L-shaped (Benders) decomposition (algos/lshaped.py) and
# its hub, after tests/test_lshaped.py, against the JAX package on the
# CPU.
#
# Tolerances: one _subproblem_cuts call from the same x̂ on sslp 5x15 at
# S=8 (subproblems solved to PDHG tol 1e-7, each package its own f32
# iterates) gives alpha and g within 1e-5 of their scale; farmer single-
# and multi-cut runs each certify a bracket around the EF value -108390
# in both packages, with the port's bounds within 2e-3 relative of the
# JAX package's (the stopping tolerance of the runs); the hub wheel with
# the x̂-L-shaped spoke certifies 5e-3 in both.
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import lshaped as jls
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.core.batch import ScenarioSpec as JSpec
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import lshaped as tls
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.core.batch import ScenarioSpec as TSpec
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)

FARMER_EF_OBJ = -108390.0


def _farmer():
    specs = [jfarmer.scenario_creator(nm, num_scens=3)
             for nm in jfarmer.scenario_names_creator(3)]
    jb = jbatch.from_specs(specs)
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def _no_recourse_specs(Spec):
    """max x, x in [0,3] nonant; recourse y in [0, 0.5] with x - y <= 1:
    feasible iff x <= 1.5 (tests/test_lshaped.py's instance)."""
    return [Spec(name=f"scen{k}", c=np.array([-1.0, ycost]),
                 A=np.array([[1.0, -1.0]]), bl=np.array([-np.inf]),
                 bu=np.array([1.0]), l=np.array([0.0, 0.0]),
                 u=np.array([3.0, 0.5]),
                 nonant_idx=np.array([0], np.int32))
            for k, ycost in enumerate([0.0, 0.01])]


def test_subproblem_cuts_match_jax_on_sslp():
    S = 8
    inst = jsslp.synthetic_instance(5, 15)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=S,
                                    lp_relax=True)
             for nm in jsslp.scenario_names_creator(S)]
    jb = jbatch.from_specs(specs)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    xhat = np.full(jb.num_nonants, 0.5, np.float32)
    jr = jls._subproblem_cuts(jb, xhat, jls.LShapedOptions().sub_pdhg)
    tr = tls._subproblem_cuts(tb, torch.as_tensor(xhat),
                              tls.LShapedOptions().sub_pdhg)
    np.testing.assert_array_equal(tr["status"].numpy(),
                                  np.asarray(jr["status"]))
    for k in ("alpha", "g", "dual", "obj"):
        j = np.asarray(jr[k])
        np.testing.assert_allclose(tr[k].numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max(), err_msg=k)
    assert tr["windows"] > 0


@pytest.mark.parametrize("multicut", [False, True])
def test_lshaped_farmer_matches_jax(multicut):
    jb, tb = _farmer()
    jres = jls.LShapedMethod(jls.LShapedOptions(
        max_iter=60, tol=2e-3, multicut=multicut), jb).lshaped_algorithm()
    ls = tls.LShapedMethod(tls.LShapedOptions(
        max_iter=60, tol=2e-3, multicut=multicut), tb)
    res = ls.lshaped_algorithm()
    assert res["bound"] <= FARMER_EF_OBJ + 40.0
    assert res["ub"] >= FARMER_EF_OBJ - 40.0
    assert res["ub"] - res["bound"] <= 2e-3 * abs(res["ub"]) + 1.0
    np.testing.assert_allclose(res["xhat"], [170.0, 80.0, 250.0], atol=8.0)
    for k in ("bound", "ub"):
        assert res[k] == pytest.approx(jres[k], rel=2e-3)
    rows = ls.trace
    assert len(rows) == res["iterations"]
    assert all(r["sub_windows"] > 0 and r["master_windows"] > 0
               for r in rows)


def test_lshaped_feasibility_cuts_match_jax():
    jb = jbatch.from_specs(_no_recourse_specs(JSpec))
    tb = tbatch.from_specs(_no_recourse_specs(TSpec), device="cpu")
    kw = dict(max_iter=40, tol=1e-3)
    jres = jls.LShapedMethod(jls.LShapedOptions(
        **kw, sub_pdhg=jls.pdhg.PDHGOptions(
            tol=1e-7, max_iters=50_000, detect_infeas=True)),
        jb).lshaped_algorithm()
    res = tls.LShapedMethod(tls.LShapedOptions(
        **kw, sub_pdhg=tpdhg.PDHGOptions(
            tol=1e-7, max_iters=50_000, detect_infeas=True)),
        tb).lshaped_algorithm()
    assert res["xhat"][0] == pytest.approx(1.5, abs=0.02)
    assert res["ub"] == pytest.approx(-1.5 + 0.005 * 0.5, abs=0.05)
    assert res["iterations"] >= 2
    assert res["xhat"][0] == pytest.approx(float(jres["xhat"][0]),
                                           abs=0.02)
    assert res["ub"] == pytest.approx(jres["ub"], abs=0.02)


def test_lshaped_hub_with_xhat_spoke():
    """The L-shaped hub with the x̂-L-shaped spoke certifies 5e-3 on
    farmer in both packages; a W-getter spoke is refused."""
    from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheel
    from mpisppy_tpu.utils import cfg_vanilla as jvanilla
    from mpisppy_tpu.utils.config import Config as JConfig
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.utils import cfg_vanilla as vanilla
    from mpisppy_tpu_torch.utils.config import Config

    def cfg_of(C):
        cfg = C()
        cfg.popular_args()
        cfg.lshaped_args()
        cfg.rel_gap = 5e-3
        cfg.lshaped_max_iter = 60
        return cfg

    jb, tb = _farmer()
    jcfg, cfg = cfg_of(JConfig), cfg_of(Config)
    jw = JWheel(jvanilla.lshaped_hub(jcfg, jb),
                [jvanilla.xhatlshaped_spoke(jcfg)]).spin()
    w = WheelSpinner(vanilla.lshaped_hub(cfg, tb),
                     [vanilla.xhatlshaped_spoke(cfg)]).spin()
    assert w.BestOuterBound <= FARMER_EF_OBJ + 40.0
    assert w.BestInnerBound >= FARMER_EF_OBJ - 40.0
    gap = w.BestInnerBound - w.BestOuterBound
    assert gap <= 5e-3 * abs(w.BestInnerBound) + 1.0
    assert w.BestOuterBound == pytest.approx(jw.BestOuterBound, rel=5e-3)
    assert w.BestInnerBound == pytest.approx(jw.BestInnerBound, rel=5e-3)
    assert w.spcomm.best_nonants().shape == (1, 3)
    bad = WheelSpinner(vanilla.lshaped_hub(cfg, _farmer()[1]),
                       [vanilla.lagrangian_spoke(cfg)])
    with pytest.raises(RuntimeError, match="W-getter"):
        bad.spin()


def test_lshaped_rejects_multistage_and_quadratic():
    from mpisppy_tpu_torch.models import ccopf
    tree = ccopf.make_tree((2, 2))
    specs = [ccopf.scenario_creator(nm, branching_factors=(2, 2))
             for nm in ccopf.scenario_names_creator(4)]
    b3 = tbatch.from_specs(specs, tree=tree, device="cpu")
    with pytest.raises(ValueError, match="two-stage"):
        tls.LShapedMethod(tls.LShapedOptions(), b3)
    # quadratic cost ON A NONANT column breaks cut affinity
    sp = _no_recourse_specs(TSpec)
    for s in sp:
        s.q = np.array([1.0, 0.0])
    with pytest.raises(ValueError, match="quadratic"):
        tls.LShapedMethod(tls.LShapedOptions(),
                          tbatch.from_specs(sp, device="cpu"))
    # quadratic cost on a RECOURSE column is fine
    sp2 = _no_recourse_specs(TSpec)
    for s in sp2:
        s.q = np.array([0.0, 1.0])
    tls.LShapedMethod(tls.LShapedOptions(),
                      tbatch.from_specs(sp2, device="cpu"))
