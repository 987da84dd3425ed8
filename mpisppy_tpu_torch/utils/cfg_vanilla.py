###############################################################################
# Vanilla hub/spoke dict factories keyed off a Config (port of
# mpisppy_tpu/utils/cfg_vanilla.py; ref:mpisppy/utils/cfg_vanilla.py:
# ph_hub:93, aph_hub:142, fwph_spoke:328, lagrangian_spoke:436,
# reduced_costs_spoke:466, lagranger_spoke:493, subgradient_spoke:526,
# xhatxbar_spoke:589, xhatshuffle_spoke:622, xhatlshaped_spoke:679,
# slammax/min_spoke:701/722, cross_scenario_cuts_spoke:743,
# ph_ob_spoke:781).
#
# The reference factories package (opt_class, comm_class, options) per
# MPI cylinder; here they package the same dicts for the one-process
# wheel: the hub owns the PH, APH or L-shaped driver on the scenario
# batch, each spoke is a batched solve over it.
###############################################################################
from __future__ import annotations

import functools
import json

from mpisppy_tpu_torch.algos import aph as aph_mod
from mpisppy_tpu_torch.algos import fwph as fwph_mod
from mpisppy_tpu_torch.algos import lshaped as ls_mod
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.cylinders import spoke as spoke_mod
from mpisppy_tpu_torch.cylinders.hub import APHHub, LShapedHub, PHHub
from mpisppy_tpu_torch.extensions.cross_scen_extension import (
    CrossScenarioExtension,
)
from mpisppy_tpu_torch.extensions.reduced_costs_fixer import (
    ReducedCostsFixer,
)
from mpisppy_tpu_torch.ops import boxqp, pdhg


def _pdhg_opts(cfg) -> pdhg.PDHGOptions:
    prec = cfg.get("iter_precision")
    # validate HERE (config time): a typo'd --iter-precision fails
    # before any solve, with the full alias list in the message
    boxqp.as_precision(prec)
    return pdhg.PDHGOptions(tol=cfg.get("pdhg_tol", 1e-6),
                            iter_precision=prec, **_guard(cfg))


def _guard(cfg) -> dict:
    """--lane-guard / --guard-max-resets / --kernel-counters as
    PDHGOptions fields."""
    return {"lane_guard": bool(cfg.get("lane_guard", False)),
            "guard_max_resets": int(cfg.get("guard_max_resets", 3)),
            "telemetry": bool(cfg.get("kernel_counters", False))}


def _hub_opts(cfg) -> dict:
    """Hub termination options (ref:hub.py:82-166 inputs) plus the
    resilience knobs (checkpoints, strike policy, bound validation,
    watchdog); the event bus itself is wired by the CLI."""
    hub_opts = {"rel_gap": cfg.get("rel_gap", 0.01),
                "display_progress": cfg.get("display_progress", False)}
    for key in ("abs_gap", "max_stalled_iters", "checkpoint_path",
                "checkpoint_every_s", "checkpoint_keep",
                "spoke_max_strikes", "bound_slack", "bound_evict_contras",
                "watchdog_budget_s", "watchdog_action",
                "watchdog_interval_s"):
        if cfg.get(key) is not None:
            hub_opts[key] = cfg[key]
    return hub_opts


def ph_options(cfg) -> ph_mod.PHOptions:
    return ph_mod.PHOptions(
        default_rho=cfg.get("default_rho", 1.0),
        max_iterations=cfg.get("max_iterations", 100),
        conv_thresh=cfg.get("convthresh", 1e-4),
        subproblem_windows=cfg.get("subproblem_windows", 8),
        pdhg=_pdhg_opts(cfg),
        smoothed=cfg.get("smoothed", False),
        smooth_beta=cfg.get("defaultPHbeta", 0.2),
        smooth_p=cfg.get("defaultPHp", 0.0),
        display_progress=cfg.get("display_progress", False),
        time_limit=cfg.get("time_limit"),
    )


def ph_hub(cfg, batch, scenario_names=None, rho_setter=None,
           extensions=None, converger=None) -> dict:
    """ref:cfg_vanilla.py:93-141."""
    return {
        "hub_class": PHHub,
        "hub_kwargs": {"options": _hub_opts(cfg)},
        "opt_class": ph_mod.PH,
        "opt_kwargs": {
            "options": ph_options(cfg),
            "batch": batch,
            "scenario_names": scenario_names,
            "rho_setter": rho_setter,
            "extensions": extensions,
            "converger": converger,
        },
    }


def aph_hub(cfg, batch, scenario_names=None, rho_setter=None,
            extensions=None, converger=None) -> dict:
    """ref:cfg_vanilla.py:142-210."""
    aph_opts = aph_mod.APHOptions(
        default_rho=cfg.get("default_rho", 1.0),
        max_iterations=cfg.get("max_iterations", 100),
        conv_thresh=cfg.get("convthresh", 1e-4),
        gamma=cfg.get("aph_gamma", 1.0),
        nu=cfg.get("aph_nu", 1.0),
        dispatch_frac=cfg.get("aph_dispatch_frac", 1.0),
        use_dynamic_gamma=cfg.get("aph_use_dynamic_gamma", False),
        subproblem_windows=cfg.get("subproblem_windows", 8),
        pdhg=_pdhg_opts(cfg),
        display_progress=cfg.get("display_progress", False),
        time_limit=cfg.get("time_limit"),
    )
    return {
        "hub_class": APHHub,
        "hub_kwargs": {"options": _hub_opts(cfg)},
        "opt_class": aph_mod.APH,
        "opt_kwargs": {
            "options": aph_opts,
            "batch": batch,
            "scenario_names": scenario_names,
            "rho_setter": rho_setter,
            "extensions": extensions,
            "converger": converger,
        },
    }


def lshaped_hub(cfg, batch, scenario_names=None) -> dict:
    """L-shaped (Benders) as the hub (the reference wires it through
    dedicated drivers)."""
    tol = cfg.get("pdhg_tol", 1e-7)
    ls_opts = ls_mod.LShapedOptions(
        max_iter=cfg.get("lshaped_max_iter", 50),
        tol=cfg.get("rel_gap", 1e-4),
        multicut=cfg.get("lshaped_multicut", False),
        sub_pdhg=pdhg.PDHGOptions(tol=tol, max_iters=100_000,
                                  detect_infeas=True, **_guard(cfg)),
        master_pdhg=pdhg.PDHGOptions(tol=tol, max_iters=200_000,
                                     **_guard(cfg)),
        display_progress=cfg.get("display_progress", False),
    )
    return {
        "hub_class": LShapedHub,
        "hub_kwargs": {"options": _hub_opts(cfg)},
        "opt_class": ls_mod.LShapedMethod,
        "opt_kwargs": {"options": ls_opts, "batch": batch,
                       "scenario_names": scenario_names},
    }


def _spoke(cls, options=None) -> dict:
    return {"spoke_class": cls, "opt_kwargs": {"options": options or {}}}


def fwph_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:328-435."""
    fw_opts = fwph_mod.FWPHOptions(
        fw_iter_limit=cfg.get("fwph_iter_limit", 2),
        fw_weight=cfg.get("fwph_weight", 0.0),
        fw_conv_thresh=cfg.get("fwph_conv_thresh", 1e-4),
        max_columns=cfg.get("fwph_max_columns", 16),
        default_rho=cfg.get("default_rho", 1.0),
        pdhg=_pdhg_opts(cfg),
    )
    return _spoke(spoke_mod.FWPHOuterBound,
                  {"pdhg_opts": _pdhg_opts(cfg), "fw_opts": fw_opts,
                   "rho": cfg.get("default_rho", 1.0)})


def lagrangian_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:436-465."""
    return _spoke(spoke_mod.LagrangianOuterBound,
                  {"pdhg_opts": _pdhg_opts(cfg)})


def lagranger_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:493-525."""
    rescale = {}
    fname = cfg.get("lagranger_rho_rescale_factors_json")
    if fname:
        with open(fname) as f:
            rescale = {int(k): float(v) for k, v in json.load(f).items()}
    return _spoke(spoke_mod.LagrangerOuterBound,
                  {"pdhg_opts": _pdhg_opts(cfg),
                   "rho": cfg.get("default_rho", 1.0),
                   "rho_rescale_factors": rescale})


def subgradient_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:526-558."""
    return _spoke(spoke_mod.SubgradientOuterBound,
                  {"pdhg_opts": _pdhg_opts(cfg),
                   "rho": cfg.get("subgradient_rho",
                                  cfg.get("default_rho", 1.0))})


def reduced_costs_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:466-492."""
    return _spoke(spoke_mod.ReducedCostsSpoke,
                  {"pdhg_opts": _pdhg_opts(cfg),
                   "rc_bound_tol": cfg.get("rc_bound_tol", 1e-6)})


def reduced_costs_fixer(cfg):
    """Factory for the hub-side fixer extension."""
    return functools.partial(
        ReducedCostsFixer,
        fix_fraction_target_iter0=cfg.get("rc_fix_fraction_iter0", 0.0),
        fix_fraction_target_iterK=cfg.get("rc_fix_fraction_iterk", 0.0),
        zero_rc_tol=cfg.get("rc_zero_rc_tol", 1e-4),
        bound_tol=cfg.get("rc_bound_tol", 1e-6),
        use_rc_bt=cfg.get("rc_bound_tightening", False),
    )


def ph_ob_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:781-820."""
    return _spoke(spoke_mod.PhOuterBound,
                  {"pdhg_opts": _pdhg_opts(cfg),
                   "rho": cfg.get("default_rho", 1.0),
                   "ph_ob_rho_rescale":
                       cfg.get("ph_ob_rho_rescale_factor", 0.1)})


def cross_scenario_cuts_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:743-780."""
    return _spoke(spoke_mod.CrossScenarioCutSpoke,
                  {"pdhg_opts": _pdhg_opts(cfg)})


def cross_scenario_extension(cfg):
    """Factory for the hub-side extension (pass as ph_hub
    extensions=...)."""
    return functools.partial(
        CrossScenarioExtension,
        check_bound_improve_iterations=cfg.get("cross_scenario_iter_cnt",
                                               4),
        max_rounds=cfg.get("cross_scenario_max_rounds", 8),
        pdhg_opts=pdhg.PDHGOptions(tol=cfg.get("pdhg_tol", 1e-6),
                                   max_iters=100_000),
    )


def xhatlshaped_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:679-700."""
    return _spoke(spoke_mod.XhatLShapedInnerBound,
                  {"pdhg_opts": _pdhg_opts(cfg)})


def xhatxbar_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:589-621."""
    return _spoke(spoke_mod.XhatXbarInnerBound,
                  {"pdhg_opts": _pdhg_opts(cfg)})


def xhatshuffle_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:622-655."""
    return _spoke(spoke_mod.XhatShuffleInnerBound,
                  {"pdhg_opts": _pdhg_opts(cfg),
                   "k": cfg.get("xhatshuffle_iter_step", 4),
                   "add_reversed": cfg.get("add_reversed_shuffle", False)})


def slammax_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:701-721."""
    return _spoke(spoke_mod.SlamMaxHeuristic,
                  {"pdhg_opts": _pdhg_opts(cfg)})


def slammin_spoke(cfg) -> dict:
    """ref:cfg_vanilla.py:722-742."""
    return _spoke(spoke_mod.SlamMinHeuristic,
                  {"pdhg_opts": _pdhg_opts(cfg)})
