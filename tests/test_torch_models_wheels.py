# Port parity: the remaining models' wheels and admm runs on the CPU,
# against the JAX package on the same batches (tests/test_torch_models_zoo.py
# holds the builders bit for bit; tests/test_torch_models_paths.py the PH
# steps and the extensive form).  The fused wheel with the EF spokes on
# hydro (3, 3), with bench.py's bench_hydro options, and on aircond
# (2, 2), with the JAX aircond wheel test's: each package certifies 1%,
# the port's bounds are the JAX package's to 1e-3 relative
# (tests/test_torch_wheel.py's bound agreement) and bracket the HiGHS EF
# optimum within the JAX tests' slack (5e-3 of |EF*|).  The admm
# wrappers' PH runs (distr through AdmmWrapper, stoch_distr through
# Stoch_AdmmWrapper) are held to the JAX runs at 1e-4 and to the merged
# LP at the JAX tests' 5e-3.
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.algos.ef import build_ef as jbuild_ef
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.cylinders import PHHub as JPHHub
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.models import distr as jdistr
from mpisppy_tpu.models import stoch_distr as jstoch_distr
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu.utils.admmWrapper import AdmmWrapper as JAdmmWrapper
from mpisppy_tpu.utils.stoch_admmWrapper import \
    Stoch_AdmmWrapper as JStoch_AdmmWrapper
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.algos.ef import build_ef as tbuild_ef
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.cylinders.hub import PHHub as TPHHub
from mpisppy_tpu_torch.models import distr as tdistr
from mpisppy_tpu_torch.models import stoch_distr as tstoch_distr
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner
from mpisppy_tpu_torch.utils.admmWrapper import AdmmWrapper as TAdmmWrapper
from mpisppy_tpu_torch.utils.stoch_admmWrapper import \
    Stoch_AdmmWrapper as TStoch_AdmmWrapper

from test_torch_models_paths import PH_TOL, highs_ef
from test_torch_models_zoo import MODELS

torch.set_num_threads(1)

WHEEL_REL = 1e-3
EF_SLACK = 5e-3


def _ef_wheel(pkg, batch, efp, rho, max_iterations, bench):
    """The hydro bench wheel (bench=True: SepRho, spoke_sync_period 5,
    the fused Lagrangian, no x̄ plane) or tests/test_models_zoo.py's
    aircond wheel, with the EF outer and root-fixed EF inner spokes."""
    import functools
    fw, hub_cls, spoke, ph_mod, pdhg_mod, Spinner = pkg
    opts = ph_mod.PHOptions(
        default_rho=rho, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=8,
        pdhg=pdhg_mod.PDHGOptions(tol=1e-6, restart_period=40))
    ef = {"ef_problem": efp, "n_windows": 20 if bench else 30}
    hub_opts = {"rel_gap": 0.01}
    opt_kwargs = {"options": opts, "batch": batch}
    spokes = [{"spoke_class": spoke.EFOuterBound,
               "opt_kwargs": {"options": ef}},
              {"spoke_class": spoke.EFXhatInnerBound,
               "opt_kwargs": {"options": ef}}]
    if bench:
        from importlib import import_module
        rs = import_module(ph_mod.__name__.replace("algos.ph",
                                                   "extensions.rho_setters"))
        hub_opts["spoke_sync_period"] = 5
        opt_kwargs["wheel_options"] = fw.FusedWheelOptions(xhat_windows=0)
        opt_kwargs["extensions"] = functools.partial(rs.SepRho,
                                                     multiplier=2.0)
        spokes.insert(1, {"spoke_class": spoke.FusedLagrangianOuterBound,
                          "opt_kwargs": {"options": {}}})
    hub = {"hub_class": hub_cls, "opt_class": fw.FusedPH,
           "opt_kwargs": opt_kwargs,
           "hub_kwargs": {"options": hub_opts}}
    ws = Spinner(hub, spokes).spin()
    return ws.BestOuterBound, ws.BestInnerBound, ws.spcomm.compute_gaps()[1]


JAX_PKG = (jfw, JPHHub, jspoke, jph, jpdhg, JWheelSpinner)
PORT_PKG = (tfw, TPHHub, tspoke, tph, tpdhg, TWheelSpinner)


@pytest.mark.parametrize("model,bfs,bench", [("hydro", (3, 3), True),
                                             ("aircond", (2, 2), False)])
def test_ef_spoke_wheel_matches_jax(model, bfs, bench):
    """The fused wheel with the EF spokes: hydro (3, 3) with bench.py's
    bench_hydro options, aircond (2, 2) with the JAX aircond wheel test's;
    each package certifies 1%, the port's bounds are the JAX package's
    to 1e-3 and bracket the HiGHS optimum."""
    jm, tm, _, _ = MODELS[model]
    names = jm.scenario_names_creator(int(np.prod(bfs)))
    kw = {"branching_factors": bfs}
    jspecs = [jm.scenario_creator(nm, **kw) for nm in names]
    tspecs = [tm.scenario_creator(nm, **kw) for nm in names]
    jt, tt = jm.make_tree(bfs), tm.make_tree(bfs)
    rho = 1.0
    jres = _ef_wheel(JAX_PKG, jbatch.from_specs(jspecs, tree=jt),
                     jbuild_ef(jspecs, tree=jt), rho, 60, bench)
    tres = _ef_wheel(PORT_PKG, tbatch.from_specs(tspecs, tree=tt,
                                                 device="cpu"),
                     tbuild_ef(tspecs, tree=tt, device="cpu"), rho, 60,
                     bench)
    opt = highs_ef(jspecs, jt)
    slack = EF_SLACK * max(1.0, abs(opt))
    for outer, inner, gap in (jres, tres):
        assert gap <= 0.01 + 1e-6
        assert outer <= opt + slack and inner >= opt - slack
    for j, t in zip(jres[:2], tres[:2]):
        assert abs(t - j) <= WHEEL_REL * abs(j)


def _admm_runs(pkg):
    """(eobj, merged LP) of distr (3 regions) through AdmmWrapper and
    stoch_distr (3 regions x 2 scenarios) through Stoch_AdmmWrapper with
    the JAX tests' PH options, in one package."""
    distr, stoch_distr, Admm, StochAdmm, ph_mod, pdhg_mod, kw = pkg
    R = 3
    data = distr.region_data(R, seed=1)
    w = Admm({}, distr.scenario_names_creator(R),
             lambda nm, **k: distr.scenario_creator(nm, data=data),
             distr.consensus_vars_creator(R, data))
    out = []
    eobj = ph_mod.PH(ph_mod.PHOptions(
        max_iterations=600, default_rho=2.0, conv_thresh=1e-7,
        subproblem_windows=10), w.make_batch(**kw)).ph_main()[1]
    out.append((eobj, distr.global_lp_oracle(data)))
    data = distr.region_data(R, seed=2)
    stoch = stoch_distr.stoch_scenario_names_creator(2)
    sw = StochAdmm({}, stoch_distr.admm_subproblem_names_creator(R), stoch,
                   lambda s, r, **k: stoch_distr.scenario_creator(
                       s, r, data=data),
                   stoch_distr.consensus_vars_creator(R, data))
    eobj = ph_mod.PH(ph_mod.PHOptions(
        default_rho=2.0, max_iterations=400, conv_thresh=2e-4,
        subproblem_windows=10,
        pdhg=pdhg_mod.PDHGOptions(tol=1e-7, restart_period=40)),
        sw.make_batch(**kw)).ph_main()[1]
    out.append((eobj, stoch_distr.global_lp_oracle(data, stoch)))
    return out


def test_admm_wrappers_match_jax_and_merged_lp():
    jruns = _admm_runs((jdistr, jstoch_distr, JAdmmWrapper,
                        JStoch_AdmmWrapper, jph, jpdhg, {}))
    truns = _admm_runs((tdistr, tstoch_distr, TAdmmWrapper,
                        TStoch_AdmmWrapper, tph, tpdhg, {"device": "cpu"}))
    for (je, jref), (te, tref) in zip(jruns, truns):
        assert tref == jref
        assert abs(te - je) <= PH_TOL * (1.0 + abs(je))
        assert abs(te - tref) <= 5e-3 * (1.0 + abs(tref))
