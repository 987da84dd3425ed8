###############################################################################
# Amalgamator: the one-call programmatic entry point (port of
# mpisppy_tpu/utils/amalgamator.py; ref:mpisppy/utils/amalgamator.py:
# 143-257).
#
# Library users and the confidence-interval code call it instead of the
# CLI: give it a Config and a model module (or the module's five
# functions) and it runs either the EF or a hub-and-spokes wheel through
# the same code paths as mpisppy_tpu_torch.generic_cylinders, then holds
# the results as attributes.
#
#   ama = amalgamator.from_module("mpisppy_tpu_torch.models.farmer", cfg)
#   ama.run()
#   ama.best_outer_bound / ama.best_inner_bound / ama.EF_Obj
#   ama.first_stage_solution   # (n_root_nonants,)
#
# The run's tensors live on cfg's `device` (default cuda, which raises
# without CUDA; put "cpu" in the Config to run on the CPU).
###############################################################################
from __future__ import annotations

import importlib
import types

import numpy as np

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.utils.config import Config


_MODULE_API = ("scenario_creator", "scenario_names_creator", "kw_creator",
               "scenario_denouement", "inparser_adder")


def _as_module(thing) -> types.ModuleType | types.SimpleNamespace:
    if isinstance(thing, str):
        return importlib.import_module(thing)
    return thing


def check_module_ama(module) -> None:
    """Verify the five-function model API
    (ref:mpisppy/utils/amalgamator.py:106-140)."""
    missing = [f for f in _MODULE_API if not hasattr(module, f)]
    if missing:
        raise RuntimeError(
            f"model module lacks required function(s): {missing} "
            "(ref:generic_cylinders.py:43-52 five-function API)")


class Amalgamator:
    """Programmatic equivalent of the generic_cylinders CLI
    (ref:mpisppy/utils/amalgamator.py:257+).

    cfg: a Config that already carries the run options (Config groups,
    or from_module() to parse an option list).  The run mode is
    cfg['EF'] (the extensive form) or the hub/spoke flags (lagrangian,
    xhatshuffle, fwph, ...)."""

    def __init__(self, cfg: Config, module,
                 scenario_creator=None, kw_creator=None, verbose=True):
        self.cfg = cfg
        self.module = _as_module(module)
        check_module_ama(self.module)
        # explicit creators, as the reference's constructor takes them
        if scenario_creator is not None or kw_creator is not None:
            ns = types.SimpleNamespace(**{
                f: getattr(self.module, f) for f in _MODULE_API})
            if scenario_creator is not None:
                ns.scenario_creator = scenario_creator
            if kw_creator is not None:
                ns.kw_creator = kw_creator
            self.module = ns
        self.verbose = verbose
        self.is_EF = bool(cfg.get("EF"))
        # results (populated by run)
        self.EF_Obj: float | None = None
        self.best_outer_bound: float | None = None
        self.best_inner_bound: float | None = None
        self.first_stage_solution: np.ndarray | None = None
        self.wheel = None
        self.ef = None

    def run(self):
        """ref:mpisppy/utils/amalgamator.py:257+ Amalgamator.run."""
        from mpisppy_tpu_torch import generic_cylinders as gc
        if self.is_EF:
            self.ef = gc._do_EF(self.cfg, self.module)
            self.EF_Obj = self.ef.get_objective_value()
            self.best_outer_bound = self.EF_Obj
            self.best_inner_bound = self.EF_Obj
            self.first_stage_solution = np.asarray(
                list(self.ef.get_root_solution().values()))
        else:
            self.wheel = gc._do_decomp(self.cfg, self.module)
            self.best_outer_bound = self.wheel.BestOuterBound
            self.best_inner_bound = self.wheel.BestInnerBound
            opt = self.wheel.opt
            if getattr(opt, "state", None) is not None \
                    and hasattr(opt, "first_stage_solution"):
                self.first_stage_solution = opt.first_stage_solution()
        global_toc("Amalgamator run done", self.verbose)
        return self


def from_module(mname, cfg: Config, scenario_creator=None,
                kw_creator=None, use_command_line: bool = False,
                args=None, verbose=True) -> Amalgamator:
    """Build an Amalgamator from a model module name or object
    (ref:mpisppy/utils/amalgamator.py:143 from_module).

    use_command_line: parse `args` (or sys.argv) through the full
    generic_cylinders flag set; otherwise `cfg` must already hold the
    options (num_scens etc.)."""
    module = _as_module(mname)
    check_module_ama(module)
    if use_command_line:
        from mpisppy_tpu_torch import generic_cylinders as gc
        cfg = gc._parse_args(module, args)
    else:
        # the module's own flags and the run's device exist with their
        # defaults even when cfg was built programmatically
        module.inparser_adder(cfg)
        cfg.device_args()
    return Amalgamator(cfg, module, scenario_creator=scenario_creator,
                       kw_creator=kw_creator, verbose=verbose)
