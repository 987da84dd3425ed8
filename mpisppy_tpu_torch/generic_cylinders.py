###############################################################################
# Generic driver CLI — the entry point of the port (port of
# mpisppy_tpu/generic_cylinders.py; ref:mpisppy/generic_cylinders.py:
# 32-312):
#
#   python -m mpisppy_tpu_torch --module-name mpisppy_tpu_torch.models.farmer \
#          --num-scens 3 --lagrangian --xhatxbar --rel-gap 0.01 \
#          [--fused-wheel --slammin] [--fwph] [--presolve] [--device cpu]
#
# The model module supplies the reference's 5-function API:
# scenario_creator, scenario_names_creator, inparser_adder, kw_creator,
# scenario_denouement — returning ScenarioSpec; multistage modules also
# provide make_tree(branching_factors).  The run's tensors live on
# --device (default cuda; without CUDA the run raises).  The last line
# of stdout is one JSON object with the bounds, the gaps and the
# iteration count.
#
# A flag of the JAX package's CLI that the port does not implement is
# refused by name (UNPORTED_FLAGS), never ignored.
###############################################################################
from __future__ import annotations

import importlib
import json
import math
import sys

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import cfg_vanilla as vanilla
from mpisppy_tpu_torch.utils.config import Config


def _queue_item(item: int, what: str) -> str:
    return f"ROADMAP.md queue A, item {item} ({what})"


_ALGOS = _queue_item(6, "the remaining algorithms and cylinders")
_OPS = _queue_item(5, "the rest of ops/ and dispatch/")
_EXT = _queue_item(8, "extensions, convergers and utils")
_TELEMETRY = _queue_item(10, "telemetry")
_RESILIENCE = _queue_item(11, "resilience and checkpoints")
_SERVING = _queue_item(13, "serving: the rolling-horizon uc windows")

# The JAX package's CLI flags (its argument groups) that the port does
# not implement, each with the queue item that ports it.
UNPORTED_FLAGS = {
    **dict.fromkeys((
        "EF", "aph_hub", "aph_gamma", "aph_nu", "aph_dispatch_frac",
        "aph_use_dynamic_gamma", "aph_frac_needed", "lagranger",
        "lagranger_rho_rescale_factors_json", "subgradient",
        "subgradient_rho", "async_staleness", "async_exchange_deadline_s",
        "reduced_costs", "rc_bound_tol", "rc_zero_rc_tol",
        "rc_fix_fraction_iter0", "rc_fix_fraction_iterk",
        "rc_bound_tightening", "ph_ob", "ph_ob_rho_rescale_factor",
        "cross_scenario_cuts", "cross_scenario_iter_cnt",
        "cross_scenario_max_rounds", "lshaped_hub", "lshaped_max_iter",
        "lshaped_multicut", "xhatlshaped"), _ALGOS),
    **dict.fromkeys((
        "dispatch_coalesce",
        "dispatch_max_batch", "dispatch_max_wait_ms",
        "dispatch_max_inflight", "dispatch_pad", "dispatch_bucket_growth",
        "dispatch_compile_guard", "dispatch_timeout_s",
        "dispatch_retry_max", "dispatch_retry_backoff_s",
        "dispatch_deadline_s"), _OPS),
    **dict.fromkeys((
        "grad_rho", "grad_order_stat", "grad_rho_update_interval",
        "grad_rho_relative_bound", "grad_rho_indep_denom", "rho_file_in",
        "rho_file_out", "sensi_rho", "sensi_rho_multiplier", "mult_rho",
        "mult_rho_update_factor", "mult_rho_update_interval",
        "use_primal_dual_converger", "primal_dual_converger_tol",
        "init_W_fname", "init_Xbar_fname", "W_fname", "Xbar_fname",
        "scenarios_per_bundle", "pickle_bundles_dir",
        "unpickle_bundles_dir"), _EXT),
    **dict.fromkeys((
        "trace_jsonl", "metrics_snapshot", "metrics_every_s",
        "telemetry_verbosity", "kernel_counters", "profile_dir",
        "profile_iters", "flight_recorder", "flight_capacity",
        "flight_dir"), _TELEMETRY),
    **dict.fromkeys((
        "checkpoint_path", "checkpoint_every_s", "checkpoint_keep",
        "checkpoint_restore", "spoke_max_strikes", "bound_slack",
        "bound_evict_contras", "lane_guard", "guard_max_resets",
        "watchdog_budget_s", "watchdog_action", "watchdog_interval_s"),
        _RESILIENCE),
    **dict.fromkeys(("uc_mpc_step", "uc_mpc_stride"), _SERVING),
    "pallas_pipeline": "no port: it double-buffers the TPU kernel's tile "
                       "DMA; on the card ops/pdhg_window.plan_window picks "
                       "the design",
}


def refuse_unported(argv) -> None:
    """Exit non-zero, naming the flag and its queue item, when `argv`
    names a flag the port does not implement."""
    for a in argv:
        if not a.startswith("--"):
            continue
        name = a[2:].split("=", 1)[0].replace("-", "_")
        if name in UNPORTED_FLAGS:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported to "
                             f"mpisppy_tpu_torch: {UNPORTED_FLAGS[name]}")


def _parse_args(module, args=None):
    """ref:generic_cylinders.py:32-80."""
    refuse_unported(sys.argv[1:] if args is None else args)
    cfg = Config()
    cfg.add_to_config("module_name", "model module to import", str, None)
    cfg.add_to_config("solution_base_name",
                      "write the first-stage solution to <name>.csv",
                      str, None)
    # the model module declares its flags FIRST: add_to_config ignores
    # re-declaration, so a module's defaults win over the groups' ones
    module.inparser_adder(cfg)
    cfg.num_scens_optional()
    cfg.popular_args()
    cfg.ph_args()
    cfg.two_sided_args()
    cfg.lagrangian_args()
    cfg.xhatxbar_args()
    cfg.fused_wheel_args()
    cfg.xhatshuffle_args()
    cfg.slama_args()
    cfg.fwph_args()
    cfg.presolve_args()
    cfg.multistage()
    cfg.device_args()
    cfg.parse_command_line("mpisppy_tpu_torch.generic_cylinders", args)
    cfg.checker()
    return cfg


def _model_plumbing(cfg, module):
    """Names, creator kwargs, and tree — the scenario count may come
    from --num-scens, the instance (e.g. sslp_15_45_10), or the
    branching factors (multistage)."""
    num_scens = cfg.get("num_scens")
    kwargs = module.kw_creator(cfg)
    if num_scens is None:
        num_scens = kwargs.get("num_scens")
    if num_scens is None and cfg.get("branching_factors"):
        num_scens = math.prod(cfg["branching_factors"])
    if num_scens is None:
        raise SystemExit("need --num-scens (or an instance implying it)")
    names = module.scenario_names_creator(int(num_scens))
    tree = None
    if hasattr(module, "make_tree") and cfg.get("branching_factors"):
        tree = module.make_tree(tuple(cfg["branching_factors"]))
    elif hasattr(module, "make_tree"):
        tree = module.make_tree()
    return names, kwargs, tree


def _presolve_maybe(cfg, batch):
    """--presolve: FBBT on the batch (ops/fbbt.presolve_batch)."""
    if not cfg.get("presolve"):
        return batch
    from mpisppy_tpu_torch.ops.fbbt import presolve_batch
    try:
        batch, info = presolve_batch(
            batch, n_sweeps=cfg.get("presolve_sweeps", 3))
    except ValueError as e:
        raise SystemExit(f"presolve: {e}")
    global_toc(f"presolve: tightened {info['tightened_bounds']} bounds",
               cfg.get("display_progress", False))
    return batch


def _build_batch(cfg, module):
    names, kwargs, tree = _model_plumbing(cfg, module)
    specs = [module.scenario_creator(nm, **kwargs) for nm in names]
    batch = _presolve_maybe(cfg, batch_mod.from_specs(
        specs, tree=tree, device=cfg.get("device", "cuda")))
    return batch, names, specs


def _fuse_wheel(cfg, hub, spokes, tree=None):
    """Swap the PH hub's driver for FusedPH and the fusable bound spokes
    (lagrangian / xhatxbar / slam / xhatshuffle) for their fused
    classes; the others (FWPH) stay classic spokes on the hub's sync
    period.  On a tree deeper than two stages the reference maps the x̄
    spoke to EFXhatInnerBound, which is not ported: refused."""
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.cylinders import spoke as spoke_mod

    fusable = {
        spoke_mod.LagrangianOuterBound: spoke_mod.FusedLagrangianOuterBound,
        spoke_mod.XhatXbarInnerBound: spoke_mod.FusedXhatXbarInnerBound,
        spoke_mod.XhatShuffleInnerBound:
            spoke_mod.FusedXhatShuffleInnerBound,
        spoke_mod.SlamMaxHeuristic: spoke_mod.FusedSlamHeuristic,
        spoke_mod.SlamMinHeuristic: spoke_mod.FusedSlamHeuristic,
    }
    present = {sd["spoke_class"] for sd in spokes}
    if spoke_mod.XhatXbarInnerBound in present and tree is not None \
            and tree.num_stages > 2:
        raise SystemExit(
            "--xhatxbar with --fused-wheel on a multistage tree needs "
            "EFXhatInnerBound, which is not ported to mpisppy_tpu_torch: "
            + _ALGOS)
    out_spokes = [{"spoke_class": fusable[sd["spoke_class"]],
                   "opt_kwargs": {"options": {}}}
                  if sd["spoke_class"] in fusable else sd for sd in spokes]
    wopts = fw.FusedWheelOptions(
        lag_windows=8 if spoke_mod.LagrangianOuterBound in present else 0,
        xhat_windows=4 if spoke_mod.XhatXbarInnerBound in present else 0,
        slam_windows=2 if (spoke_mod.SlamMaxHeuristic in present
                           or spoke_mod.SlamMinHeuristic in present)
        else 0,
        slam_sense_max=spoke_mod.SlamMinHeuristic not in present,
        shuffle_windows=4 if spoke_mod.XhatShuffleInnerBound in present
        else 0,
        spoke_period=max(1, int(cfg.get("fused_spoke_period", 1) or 1)))
    hub = dict(hub)
    hub["opt_class"] = fw.FusedPH
    hub["opt_kwargs"] = dict(hub.get("opt_kwargs", {}))
    hub["opt_kwargs"]["wheel_options"] = wopts
    return hub, out_spokes


def build_wheel(cfg, module):
    """Assemble (hub, spokes, names, specs, batch) from a parsed
    Config."""
    batch, names, specs = _build_batch(cfg, module)
    hub = vanilla.ph_hub(cfg, batch, scenario_names=names)
    spokes = []
    if cfg.get("fwph"):
        spokes.append(vanilla.fwph_spoke(cfg))
    if cfg.get("lagrangian"):
        spokes.append(vanilla.lagrangian_spoke(cfg))
    if cfg.get("xhatxbar"):
        spokes.append(vanilla.xhatxbar_spoke(cfg))
    if cfg.get("xhatshuffle"):
        spokes.append(vanilla.xhatshuffle_spoke(cfg))
    if cfg.get("slammax"):
        spokes.append(vanilla.slammax_spoke(cfg))
    if cfg.get("slammin"):
        spokes.append(vanilla.slammin_spoke(cfg))
    if cfg.get("fused_wheel"):
        hub, spokes = _fuse_wheel(cfg, hub, spokes, tree=batch.tree)
    return hub, spokes, names, specs, batch


def _finite(v):  # strict-JSON safe: a bound that never landed -> null
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def _spin_and_report(cfg, module, hub, spokes, names, specs):
    wheel = WheelSpinner(hub, spokes).spin()
    abs_gap, rel_gap = wheel.spcomm.compute_gaps()
    global_toc(
        f"outer {wheel.BestOuterBound:.6g} inner {wheel.BestInnerBound:.6g}"
        f" rel_gap {rel_gap:.3e}", True)
    if cfg.get("solution_base_name"):
        wheel.write_first_stage_solution(cfg["solution_base_name"] + ".csv")
    for rank0, nm in enumerate(names):
        module.scenario_denouement(0, nm, specs[rank0])
    # the reference's fault-domain counters: no dispatch scheduler or
    # watchdog is ported, so they are 0
    print(json.dumps({
        "outer_bound": _finite(wheel.BestOuterBound),
        "inner_bound": _finite(wheel.BestInnerBound),
        "abs_gap": _finite(abs_gap), "rel_gap": _finite(rel_gap),
        "iterations": wheel.spcomm._iter,
        "dispatch_retries": 0,
        "dispatch_quarantined_lanes": 0,
        "watchdog_trips": 0,
    }), flush=True)
    return wheel


def main(args=None):
    """Run the CLI on `args` (default: sys.argv[1:]); returns the
    spun WheelSpinner."""
    argv = list(sys.argv[1:] if args is None else args)
    module_name = None
    for i, a in enumerate(argv):
        if a == "--module-name" and i + 1 < len(argv):
            module_name = argv[i + 1]
        elif a.startswith("--module-name="):
            module_name = a.split("=", 1)[1]
    if module_name is None:
        raise SystemExit(
            "usage: python -m mpisppy_tpu_torch --module-name <module> ...")
    if "." not in sys.path:
        sys.path.insert(0, ".")
    module = importlib.import_module(module_name)
    cfg = _parse_args(module, argv)
    hub, spokes, names, specs, _ = build_wheel(cfg, module)
    return _spin_and_report(cfg, module, hub, spokes, names, specs)


if __name__ == "__main__":
    main()
