###############################################################################
# Vanilla hub/spoke dict factories keyed off a Config (port of
# mpisppy_tpu/utils/cfg_vanilla.py; ref:mpisppy/utils/cfg_vanilla.py:
# ph_hub:93, fwph_spoke:328, lagrangian_spoke:436, xhatxbar_spoke:589,
# xhatshuffle_spoke:622, slammax/min_spoke:701/722).
#
# The reference factories package (opt_class, comm_class, options) per
# MPI cylinder; here they package the same dicts for the one-process
# wheel: the hub owns the PH driver on the scenario batch, each spoke is
# a batched solve over it.
###############################################################################
from __future__ import annotations

from mpisppy_tpu_torch.algos import fwph as fwph_mod
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.cylinders import spoke as spoke_mod
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.ops import boxqp, pdhg


def _pdhg_opts(cfg) -> pdhg.PDHGOptions:
    prec = cfg.get("iter_precision")
    # validate HERE (config time): a typo'd --iter-precision fails
    # before any solve, with the full alias list in the message
    boxqp.as_precision(prec)
    return pdhg.PDHGOptions(tol=cfg.get("pdhg_tol", 1e-6),
                            iter_precision=prec)


def _hub_opts(cfg) -> dict:
    """Hub termination options (ref:hub.py:82-166 inputs)."""
    hub_opts = {"rel_gap": cfg.get("rel_gap", 0.01),
                "display_progress": cfg.get("display_progress", False)}
    for key in ("abs_gap", "max_stalled_iters"):
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
