###############################################################################
# Generic driver CLI — the entry point of the port (port of
# mpisppy_tpu/generic_cylinders.py; ref:mpisppy/generic_cylinders.py:
# 32-312):
#
#   python -m mpisppy_tpu_torch --module-name mpisppy_tpu_torch.models.farmer \
#          --num-scens 3 --lagrangian --xhatxbar --rel-gap 0.01 \
#          [--fused-wheel --slammin] [--fwph] [--presolve] [--device cpu]
#   python -m mpisppy_tpu_torch --module-name ... --lshaped-hub --xhatlshaped
#   python -m mpisppy_tpu_torch --module-name ... --aph-hub --lagrangian
#   python -m mpisppy_tpu_torch --module-name ... --num-scens 3 --EF
#   python -m mpisppy_tpu_torch --module-name ... --fused-wheel \
#          --lagrangian --xhatxbar --async-staleness 1 --trace-jsonl t.jsonl
#   python -m mpisppy_tpu_torch --module-name ... --grad-rho \
#          --use-primal-dual-converger --W-fname w.csv --rho-file-out r.csv
#   python -m mpisppy_tpu_torch --module-name ... --scenarios-per-bundle 10
#   python -m mpisppy_tpu_torch --module-name mpisppy_tpu_torch.models.uc \
#          ... --uc-mpc-step 1 --uc-mpc-stride 1     (a rolling-horizon window)
#
# The model module supplies the reference's 5-function API:
# scenario_creator, scenario_names_creator, inparser_adder, kw_creator,
# scenario_denouement — returning ScenarioSpec; multistage modules also
# provide make_tree(branching_factors).  The run's tensors live on
# --device (default cuda; without CUDA the run raises).  The last line
# of stdout is one JSON object with the bounds, the gaps, the iteration
# count and the dispatch scheduler's fault-domain counters (--EF: the EF
# objective and whether its solve converged).  The --dispatch-* group
# configures the process-default scheduler every MIP solve goes through;
# --async-staleness swaps in the async exchange wheel (algos/
# async_wheel.py); the telemetry group builds the run's event bus
# (--trace-jsonl writes the JAX package's trace schema), arms the kernel
# counters (--kernel-counters), the device profile (--profile-dir,
# --profile-iters: a torch.profiler window over hub iterations, read back
# into <profile-dir>/device_profile.json) and an always-on flight
# recorder; the resilience group sets the rotated checkpoints
# (--checkpoint-path, a SIGTERM/SIGINT emergency save, exit 75 on
# preemption and --checkpoint-restore to resume), the strike policy, the
# PDHG lane guard and the hub watchdog.  The dynamic rho flags
# (--grad-rho*, --sensi-rho*, --mult-rho*) and the W/x̄ files
# (--W-fname, --Xbar-fname, --init-W-fname, --init-Xbar-fname) add PH
# hub extensions; --rho-file-in sets the starting rho and --rho-file-out
# writes the final one; --use-primal-dual-converger gives the PH or APH
# hub a converger; --scenarios-per-bundle runs PH over proper bundles
# (--pickle-bundles-dir / --unpickle-bundles-dir).
#
# A flag of the JAX package's CLI that the port does not implement is
# refused by name (UNPORTED_FLAGS), never ignored.
###############################################################################
from __future__ import annotations

import importlib
import json
import math
import sys

from mpisppy_tpu_torch import dispatch as _dispatch
from mpisppy_tpu_torch import global_toc, telemetry
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.resilience.faults import PreemptionError
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import cfg_vanilla as vanilla
from mpisppy_tpu_torch.utils.config import Config


# The JAX package's CLI flags (its argument groups) that the port does
# not implement, each with the reason.
UNPORTED_FLAGS = {
    "pallas_pipeline": "no port: it double-buffers the TPU kernel's tile "
                       "DMA; on the card ops/pdhg_window.plan_window picks "
                       "the design",
}


def refuse_unported(argv) -> None:
    """Exit non-zero, naming the flag and why it is not ported, when
    `argv` names a flag the port does not implement."""
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
    cfg.add_to_config("EF", "solve the extensive form directly", bool,
                      False)
    cfg.add_to_config("solution_base_name",
                      "write the first-stage solution to <name>.csv",
                      str, None)
    # the model module declares its flags FIRST: add_to_config ignores
    # re-declaration, so a module's defaults win over the groups' ones
    module.inparser_adder(cfg)
    cfg.num_scens_optional()
    cfg.popular_args()
    cfg.ph_args()
    cfg.aph_args()
    cfg.two_sided_args()
    cfg.fwph_args()
    cfg.lagrangian_args()
    cfg.lagranger_args()
    cfg.subgradient_args()
    cfg.xhatxbar_args()
    cfg.fused_wheel_args()
    cfg.xhatshuffle_args()
    cfg.slama_args()
    cfg.gradient_args()
    cfg.dynamic_rho_args()
    cfg.reduced_costs_args()
    cfg.ph_ob_args()
    cfg.cross_scenario_cuts_args()
    cfg.lshaped_args()
    cfg.converger_args()
    cfg.presolve_args()
    cfg.resilience_args()
    cfg.telemetry_args()
    cfg.dispatch_args()
    cfg.wxbar_read_write_args()
    cfg.proper_bundle_config()
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
    """(batch, names, specs): the model's scenarios, or with
    --scenarios-per-bundle its proper bundles (each the EF of that many
    scenarios, utils/proper_bundler.py; --pickle-bundles-dir writes them,
    --unpickle-bundles-dir reads them back)."""
    names, kwargs, tree = _model_plumbing(cfg, module)
    device = cfg.get("device", "cuda")
    if cfg.get("scenarios_per_bundle"):
        from mpisppy_tpu_torch.utils.pickle_bundle import check_args
        from mpisppy_tpu_torch.utils.proper_bundler import ProperBundler
        if tree is not None:
            raise SystemExit("proper bundles are two-stage only "
                             "(ref:proper_bundler.py:22); drop "
                             "--scenarios-per-bundle or the "
                             "branching factors")
        check_args(cfg)
        if cfg.get("num_scens") is None:
            cfg.quick_assign("num_scens", int, len(names))
        pb = ProperBundler(module)
        num_buns = len(names) // int(cfg["scenarios_per_bundle"])
        kwargs = pb.kw_creator(cfg)
        names = pb.bundle_names_creator(num_buns, cfg=cfg)
        specs = [pb.scenario_creator(nm, **kwargs) for nm in names]
        return _presolve_maybe(cfg, batch_mod.from_specs(
            specs, device=device)), names, specs
    specs = [module.scenario_creator(nm, **kwargs) for nm in names]
    batch = _presolve_maybe(cfg, batch_mod.from_specs(
        specs, tree=tree, device=device))
    return batch, names, specs


def _fuse_wheel(cfg, hub, spokes, specs=None, tree=None):
    """Swap the PH hub's driver for FusedPH and the fusable bound spokes
    (lagrangian / xhatxbar / slam / xhatshuffle) for their fused
    classes; the others (cut providers, FWPH, reduced costs, ...) stay
    classic spokes on the hub's sync period.  On a tree deeper than two
    stages the x̄ recourse planes would fix EVERY stage's nonants, which
    is infeasible whenever a later-stage equality couples nonants with
    stage randomness: there the x̄ spoke maps to EFXhatInnerBound
    (root-fixed EF with intra-tree nonanticipativity).
    --async-staleness s >= 1 swaps in the async pair (AsyncPHHub /
    AsyncFusedPH); 0 keeps the synchronous one."""
    import dataclasses

    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.cylinders import spoke as spoke_mod

    multistage = tree is not None and tree.num_stages > 2
    fusable = {
        spoke_mod.LagrangianOuterBound: spoke_mod.FusedLagrangianOuterBound,
        spoke_mod.XhatXbarInnerBound: spoke_mod.FusedXhatXbarInnerBound,
        spoke_mod.XhatShuffleInnerBound:
            spoke_mod.FusedXhatShuffleInnerBound,
        spoke_mod.SlamMaxHeuristic: spoke_mod.FusedSlamHeuristic,
        spoke_mod.SlamMinHeuristic: spoke_mod.FusedSlamHeuristic,
    }
    present = set()
    out_spokes = []
    for sd in spokes:
        cls = sd["spoke_class"]
        if cls is spoke_mod.XhatXbarInnerBound and multistage \
                and specs is not None:
            out_spokes.append({
                "spoke_class": spoke_mod.EFXhatInnerBound,
                "opt_kwargs": {"options": {"specs": specs,
                                           "tree": tree}}})
        elif cls in fusable:
            present.add(cls)
            out_spokes.append({"spoke_class": fusable[cls],
                               "opt_kwargs": {"options": {}}})
        else:
            out_spokes.append(sd)
    # --lane-guard and --kernel-counters must reach the fused planes'
    # PDHG options too, or they would cover only the hub's subproblems
    defaults = fw.FusedWheelOptions()
    guard = vanilla._guard(cfg)
    wopts = fw.FusedWheelOptions(
        lag_pdhg=dataclasses.replace(defaults.lag_pdhg, **guard),
        xhat_pdhg=dataclasses.replace(defaults.xhat_pdhg, **guard),
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
    staleness = max(0, int(cfg.get("async_staleness", 0) or 0))
    if staleness > 0:
        from mpisppy_tpu_torch.algos import async_wheel as aw
        from mpisppy_tpu_torch.cylinders.hub import AsyncPHHub
        hub["hub_class"] = AsyncPHHub
        hub["opt_class"] = aw.AsyncFusedPH
        ddl = float(cfg.get("async_exchange_deadline_s", 0.0) or 0.0)
        hub["opt_kwargs"]["async_options"] = aw.AsyncWheelOptions(
            staleness=staleness,
            exchange_deadline_s=ddl if ddl > 0 else None)
        hub["hub_kwargs"] = dict(hub.get("hub_kwargs", {}))
        hub_opts = dict(hub["hub_kwargs"].get("options", {}))
        hub_opts["async_staleness"] = staleness
        hub["hub_kwargs"]["options"] = hub_opts
    return hub, out_spokes


def _ph_extensions(cfg):
    """The PH hub's extensions the flags ask for (composed with
    MultiExtension when several): the cross-scenario cut installer, the
    reduced-costs fixer, the dynamic rho setters (--grad-rho,
    --sensi-rho, --mult-rho) and the W/x̄ file writer and reader."""
    import functools

    from mpisppy_tpu_torch.extensions import rho_setters, wxbar_io
    factories = []
    if cfg.get("cross_scenario_cuts"):
        factories.append(vanilla.cross_scenario_extension(cfg))
    if cfg.get("reduced_costs"):
        factories.append(vanilla.reduced_costs_fixer(cfg))
    if cfg.get("grad_rho"):
        factories.append(functools.partial(
            rho_setters.Gradient_extension,
            grad_order_stat=cfg.get("grad_order_stat", 0.5),
            grad_rho_update_interval=cfg.get("grad_rho_update_interval", 5),
            indep_denom=cfg.get("grad_rho_indep_denom", False),
            grad_rho_relative_bound=cfg.get("grad_rho_relative_bound",
                                            1e3)))
    if cfg.get("sensi_rho"):
        factories.append(functools.partial(
            rho_setters.SensiRho,
            sensi_rho_multiplier=cfg.get("sensi_rho_multiplier", 1.0)))
    if cfg.get("mult_rho"):
        factories.append(functools.partial(
            rho_setters.MultRhoUpdater,
            mult_rho_update_factor=cfg.get("mult_rho_update_factor", 2.0),
            mult_rho_update_interval=cfg.get("mult_rho_update_interval",
                                             2)))
    if cfg.get("W_fname") or cfg.get("Xbar_fname"):
        factories.append(functools.partial(
            wxbar_io.WXBarWriter, W_fname=cfg.get("W_fname"),
            Xbar_fname=cfg.get("Xbar_fname")))
    if cfg.get("init_W_fname") or cfg.get("init_Xbar_fname"):
        factories.append(functools.partial(
            wxbar_io.WXBarReader, init_W_fname=cfg.get("init_W_fname"),
            init_Xbar_fname=cfg.get("init_Xbar_fname")))
    if len(factories) <= 1:
        return factories[0] if factories else None
    from mpisppy_tpu_torch.extensions.extension import MultiExtension
    return functools.partial(MultiExtension, ext_classes=factories)


def _converger(cfg):
    """--use-primal-dual-converger: the hub algorithm's converger factory."""
    if not cfg.get("use_primal_dual_converger"):
        return None
    import functools

    from mpisppy_tpu_torch.convergers.primal_dual_converger import (
        PrimalDualConverger,
    )
    return functools.partial(
        PrimalDualConverger,
        tol=cfg.get("primal_dual_converger_tol", 1e-2))


def build_wheel(cfg, module, batch=None):
    """Assemble (hub, spokes, names, specs, batch) from a parsed
    Config: the hub from --lshaped-hub, --aph-hub or PH (in that order
    of precedence, as the JAX package), then the spoke list.  `batch`: a
    prepared batch of the same model to build the wheel on instead (a
    parallel.mesh.shard_batch-ed one: the CLI has no mesh flag); specs
    are then None."""
    if batch is None:
        batch, names, specs = _build_batch(cfg, module)
    else:
        names, specs = _model_plumbing(cfg, module)[0], None
    converger = _converger(cfg)
    lshaped, aph = cfg.get("lshaped_hub"), cfg.get("aph_hub")
    if lshaped:
        if cfg.get("checkpoint_path"):
            from mpisppy_tpu_torch.cylinders.hub import CheckpointUnsupported
            raise CheckpointUnsupported(
                "--checkpoint-path is refused with --lshaped-hub: the "
                "L-shaped method keeps no restorable state (its cut "
                "buffer grows every Benders iteration)")
        if converger is not None:
            global_toc("WARNING: converger options are ignored with "
                       "--lshaped-hub (Benders has its own termination)",
                       True)
        if aph:
            global_toc("WARNING: --aph-hub is ignored because "
                       "--lshaped-hub is also set", True)
        hub = vanilla.lshaped_hub(cfg, batch, scenario_names=names)
    elif aph:
        hub = vanilla.aph_hub(cfg, batch, scenario_names=names,
                              converger=converger)
    else:
        rho_setter = None
        if cfg.get("rho_file_in"):
            from mpisppy_tpu_torch.utils.gradient import Set_Rho
            rho_setter = Set_Rho(cfg).rho_setter
        hub = vanilla.ph_hub(cfg, batch, scenario_names=names,
                             converger=converger,
                             extensions=_ph_extensions(cfg),
                             rho_setter=rho_setter)
    spokes = []
    if not lshaped and not aph:
        if cfg.get("cross_scenario_cuts"):
            spokes.append(vanilla.cross_scenario_cuts_spoke(cfg))
        if cfg.get("reduced_costs"):
            spokes.append(vanilla.reduced_costs_spoke(cfg))
    for flag, factory in (("ph_ob", vanilla.ph_ob_spoke),
                          ("xhatlshaped", vanilla.xhatlshaped_spoke),
                          ("fwph", vanilla.fwph_spoke),
                          ("lagrangian", vanilla.lagrangian_spoke),
                          ("lagranger", vanilla.lagranger_spoke),
                          ("subgradient", vanilla.subgradient_spoke),
                          ("xhatxbar", vanilla.xhatxbar_spoke),
                          ("xhatshuffle", vanilla.xhatshuffle_spoke),
                          ("slammax", vanilla.slammax_spoke),
                          ("slammin", vanilla.slammin_spoke)):
        if cfg.get(flag):
            spokes.append(factory(cfg))
    if cfg.get("fused_wheel") and not lshaped and not aph:
        hub, spokes = _fuse_wheel(cfg, hub, spokes, specs=specs,
                                  tree=batch.tree)
    elif int(cfg.get("async_staleness", 0) or 0) > 0:
        why = ("--fused-wheel is vetoed by --aph-hub/--lshaped-hub here"
               if cfg.get("fused_wheel") else "requires --fused-wheel")
        global_toc(f"WARNING: --async-staleness {why} "
                   "(the async exchange plane is the fused wheel's); "
                   "running synchronous", True)
    return hub, spokes, names, specs, batch


def _finite(v):  # strict-JSON safe: a bound that never landed -> null
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def _report_device_profile(profile_dir: str) -> None:
    """A --profile-dir run reads its own capture: the roofline of the
    newest capture under profile_dir (the ProfilerSession's) goes next
    to it as device_profile.json, the form `telemetry gate` reads, and
    the headline device numbers go to the console."""
    import os

    from mpisppy_tpu_torch.telemetry import deviceprof, roofline
    try:
        cap = deviceprof.newest_capture(profile_dir)
        if cap is None:
            return
        rep = roofline.roofline(deviceprof.build_timeline(cap))
    except (OSError, ValueError) as e:
        global_toc(f"device profile unreadable under {profile_dir}: {e}",
                   True)
        return
    out_path = os.path.join(profile_dir, "device_profile.json")
    try:
        from mpisppy_tpu_torch.utils.atomic_io import atomic_write_text
        atomic_write_text(out_path, json.dumps(rep, indent=1) + "\n")
    except OSError:
        out_path = "(unwritable)"

    def _g(v):
        return "-" if v is None else format(v, ".4g")
    global_toc(
        f"device profile: sec/iter {_g(rep.get('device_sec_per_iter'))}"
        f"  busy {_g(rep.get('busy_share'))}"
        f"  stream {_g(rep.get('measured_stream_gbps'))} GB/s"
        f"  hbm {_g(rep.get('achieved_hbm_gbps'))}/"
        f"{_g(rep.get('peak_hbm_gbps'))} GB/s"
        f"  overlap {_g(rep.get('overlap_frac'))}  -> {out_path}", True)


def _spin_and_report(cfg, module, hub, spokes, names, specs):
    wheel = WheelSpinner(hub, spokes)
    ckpt = cfg.get("checkpoint_path")
    if ckpt and cfg.get("checkpoint_restore"):
        wheel.build()
        if wheel.spcomm._checkpoint_candidates(ckpt):
            try:
                wheel.spcomm.load_checkpoint(ckpt)
                global_toc(f"restored checkpoint {ckpt} at hub iter "
                           f"{wheel.spcomm._iter}; resuming", True)
            except FileNotFoundError as e:
                # snapshots exist but none validates: crashing here would
                # restart-storm the pool against the same dead files —
                # start fresh instead, loudly
                global_toc(f"WARNING: no valid checkpoint to restore "
                           f"({e}); starting fresh", True)
    try:
        wheel.spin()
    except PreemptionError as e:
        # WheelSpinner.spin already wrote the emergency checkpoint;
        # EX_TEMPFAIL tells the pool scheduler to restart the run
        global_toc(f"run preempted ({e}); restart with "
                   f"--checkpoint-restore to resume", True)
        print(json.dumps({"preempted": True, "checkpoint_path": ckpt,
                          "iterations": wheel.spcomm._iter}), flush=True)
        raise SystemExit(75)
    abs_gap, rel_gap = wheel.spcomm.compute_gaps()
    global_toc(
        f"outer {wheel.BestOuterBound:.6g} inner {wheel.BestInnerBound:.6g}"
        f" rel_gap {rel_gap:.3e}", True)
    if cfg.get("profile_dir"):
        _report_device_profile(cfg["profile_dir"])
    if cfg.get("solution_base_name"):
        wheel.write_first_stage_solution(cfg["solution_base_name"] + ".csv")
    if cfg.get("rho_file_out") \
            and getattr(wheel.opt, "state", None) is not None \
            and hasattr(wheel.opt.state, "rho"):
        from mpisppy_tpu_torch.utils.rho_utils import rhos_to_csv
        rhos_to_csv(wheel.opt.state.rho.cpu().numpy(), cfg["rho_file_out"])
    for rank0, nm in enumerate(names):
        module.scenario_denouement(0, nm, specs[rank0])
    # the fault-domain counters: the scheduler's retries and quarantined
    # lanes, the watchdog's trips
    dstats = _dispatch.scheduler_stats() or {}
    wd = wheel.spcomm._watchdog
    print(json.dumps({
        "outer_bound": _finite(wheel.BestOuterBound),
        "inner_bound": _finite(wheel.BestInnerBound),
        "abs_gap": _finite(abs_gap), "rel_gap": _finite(rel_gap),
        "iterations": wheel.spcomm._iter,
        "dispatch_retries": dstats.get("retries_total", 0),
        "dispatch_quarantined_lanes": dstats.get("quarantined_lanes", 0),
        "watchdog_trips": 0 if wd is None else wd.trips,
    }), flush=True)
    return wheel


def _do_EF(cfg, module):
    """--EF: the extensive form solved directly as one LP
    (ref:generic_cylinders.py:396-457); prints {"EF_objective": ...,
    "converged": ...} as the last line."""
    from mpisppy_tpu_torch.algos import ef as ef_mod
    # no hub emits wheel events here, but --trace-jsonl /
    # --metrics-snapshot still capture the console stream and a final
    # metrics snapshot
    tel_bus = telemetry.from_cfg(cfg)
    try:
        names, kwargs, tree = _model_plumbing(cfg, module)
        ef = ef_mod.ExtensiveForm({"tol": cfg.get("pdhg_tol", 1e-6)},
                                  names, module.scenario_creator, kwargs,
                                  tree=tree,
                                  device=cfg.get("device", "cuda"))
        st = ef.solve_extensive_form()
        obj = ef.get_objective_value()
        converged = bool(st.done.all())
        global_toc(f"EF objective: {obj:.6g} (converged={converged})",
                   True)
        if cfg.get("solution_base_name"):
            import numpy as np
            np.save(cfg["solution_base_name"] + ".npy",
                    np.asarray(list(ef.get_root_solution().values())))
    finally:
        telemetry.close_bus(tel_bus)
    print(json.dumps({"EF_objective": obj, "converged": converged}),
          flush=True)
    return ef


def main(args=None):
    """Run the CLI on `args` (default: sys.argv[1:]); returns the
    spun WheelSpinner (the ExtensiveForm under --EF)."""
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
    if cfg.get("EF"):
        return _do_EF(cfg, module)
    return _do_decomp(cfg, module)


def _do_decomp(cfg, module):
    """Build the wheel, wire its telemetry and dispatch scheduler, spin
    and report.  The flight recorder rides every run (a private bus
    carries it, and the console stream, when no --trace-jsonl /
    --metrics-snapshot bus exists): a wheel that dies leaves
    flight-<runid>.jsonl behind."""
    hub, spokes, names, specs, _ = build_wheel(cfg, module)
    tel_bus = telemetry.from_cfg(cfg)
    wheel_bus, own_bus = tel_bus, False
    if cfg.get("flight_recorder", True):
        from mpisppy_tpu_torch.telemetry import flightrec
        if wheel_bus is None:
            wheel_bus = telemetry.EventBus()
            telemetry.console.attach(wheel_bus)
            own_bus = True
        wheel_bus.subscribe(flightrec.FlightRecorder(
            capacity=int(cfg.get("flight_capacity", 512)),
            dump_dir=cfg.get("flight_dir", ".")))
    # the scheduler's megabatch events land in the trace too
    _dispatch.from_cfg(cfg, bus=wheel_bus)
    if wheel_bus is not None:
        hub = dict(hub)
        hub["hub_kwargs"] = dict(hub.get("hub_kwargs", {}))
        hub_opts = dict(hub["hub_kwargs"].get("options", {}))
        hub_opts["telemetry_bus"] = wheel_bus
        hub["hub_kwargs"]["options"] = hub_opts
    try:
        return _spin_and_report(cfg, module, hub, spokes, names, specs)
    finally:
        if own_bus:
            telemetry.console.detach(wheel_bus)
            wheel_bus.close()
        telemetry.close_bus(tel_bus)


if __name__ == "__main__":
    main()
