###############################################################################
# Config: the option system with an argparse bridge (port of
# mpisppy_tpu/utils/config.py; ref:mpisppy/utils/config.py:54-157).
#
# A small dict of declared entries: add_to_config(), attribute and dict
# access, quick_assign, the canned argument groups, and
# parse_command_line() building an argparse parser from the declared
# entries (dashes in flag names, underscores in attribute names).  Only
# the groups of features the port has are here; the generic driver
# refuses the JAX package's other flags by name (generic_cylinders.py
# UNPORTED_FLAGS).
###############################################################################
from __future__ import annotations

import argparse
import dataclasses
from typing import Any


@dataclasses.dataclass
class _Entry:
    name: str
    description: str
    domain: type | None
    default: Any
    value: Any
    argparse: bool = True


def _boolify(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


class Config:
    """ref:mpisppy/utils/config.py:54 — declare options, then parse."""

    def __init__(self):
        object.__setattr__(self, "_entries", {})

    # -- core declaration/access (ref:config.py:64-140) -------------------
    def add_to_config(self, name: str, description: str, domain=str,
                      default=None, argparse: bool = True,
                      complain: bool = False):
        if name in self._entries:
            if complain:
                raise RuntimeError(f"option {name} already declared")
            return
        self._entries[name] = _Entry(name, description, domain, default,
                                     default, argparse)

    def quick_assign(self, name: str, domain=str, value=None):
        """declare-and-set (ref:config.py:118)."""
        self.add_to_config(name, name, domain, value, argparse=False)
        self._entries[name].value = value

    def __getattr__(self, name):
        entries = object.__getattribute__(self, "_entries")
        if name in entries:
            return entries[name].value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._entries:
            self._entries[name].value = value
        else:
            self.quick_assign(name, type(value), value)

    def __contains__(self, name):
        return name in self._entries

    def __getitem__(self, name):
        return self._entries[name].value

    def get(self, name, default=None):
        e = self._entries.get(name)
        return default if e is None or e.value is None else e.value

    # -- canned groups (ref:config.py:174-976) ----------------------------
    def num_scens_required(self):
        self.add_to_config("num_scens", "number of scenarios", int, None)

    def num_scens_optional(self):
        self.add_to_config("num_scens", "number of scenarios", int, None)

    def popular_args(self):
        """ref:config.py:174-249 (solver options dropped: the solver is
        in-repo; PDHG knobs take their place)."""
        self.add_to_config("max_iterations", "PH max iterations", int, 100)
        self.add_to_config("time_limit", "wall clock limit (sec)", float,
                           None)
        self.add_to_config("default_rho", "PH rho", float, 1.0)
        self.add_to_config("rel_gap", "relative termination gap", float,
                           0.01)
        self.add_to_config("abs_gap", "absolute termination gap", float,
                           None)
        self.add_to_config("max_stalled_iters", "stall termination", int,
                           None)
        self.add_to_config("display_progress", "per-iter trace", bool,
                           False)
        self.add_to_config("pdhg_tol", "subproblem KKT tolerance", float,
                           1e-6)
        self.add_to_config("subproblem_windows",
                           "PDHG restart windows per PH iteration", int, 8)
        self.add_to_config("iter_precision",
                           "arithmetic of the window kernel's iteration "
                           "matvecs: bf16x3 (3-product bf16 split on "
                           "tensor cores) or bf16x6/f32 (IEEE f32, the "
                           "default when unset).  Restart scoring, "
                           "convergence tests and certificates always run "
                           "in f32", str, None)

    def two_sided_args(self):
        self.add_to_config("rel_gap", "relative termination gap", float,
                           0.01)
        self.add_to_config("abs_gap", "absolute termination gap", float,
                           None)

    def ph_args(self):
        """ref:config.py:250-315."""
        self.popular_args()
        self.add_to_config("convthresh", "PH convergence threshold", float,
                           1e-4)
        self.add_to_config("smoothed", "use smoothing", bool, False)
        self.add_to_config("defaultPHbeta", "smoothing beta", float, 0.2)
        self.add_to_config("defaultPHp", "smoothing p coefficient", float,
                           0.0)

    def presolve_args(self):
        """Batched FBBT presolve (ref:mpisppy/opt/presolve.py via the
        reference's 'presolve' option; here ops/fbbt.py)."""
        self.add_to_config("presolve",
                           "run FBBT bound tightening on the batch",
                           bool, False)
        self.add_to_config("presolve_sweeps",
                           "FBBT interval-tightening sweeps", int, 3)

    def fwph_args(self):
        """ref:config.py:487-520."""
        self.add_to_config("fwph", "use an FWPH outer-bound spoke", bool,
                           False)
        self.add_to_config("fwph_iter_limit", "FWPH inner iterations", int,
                           2)
        self.add_to_config("fwph_max_columns", "FWPH column-buffer size",
                           int, 16)
        self.add_to_config("fwph_weight", "FWPH weight", float, 0.0)
        self.add_to_config("fwph_conv_thresh", "FWPH convergence", float,
                           1e-4)

    def lagrangian_args(self):
        """ref:config.py:521-538."""
        self.add_to_config("lagrangian", "use a Lagrangian bound spoke",
                           bool, False)

    def xhatxbar_args(self):
        self.add_to_config("xhatxbar", "use an xhat-xbar inner spoke",
                           bool, False)

    def fused_wheel_args(self):
        """Run the requested lagrangian/xhatxbar/slam/xhatshuffle planes
        inside the hub's iteration (algos/fused_wheel.py)."""
        self.add_to_config("fused_wheel",
                           "fuse the bound spokes into the hub step",
                           bool, False)
        self.add_to_config("fused_spoke_period",
                           "run fused planes every k-th iteration",
                           int, 1)

    def xhatshuffle_args(self):
        """ref:config.py:676-699."""
        self.add_to_config("xhatshuffle", "use an xhat shuffle spoke",
                           bool, False)
        self.add_to_config("add_reversed_shuffle", "also reversed order",
                           bool, False)
        self.add_to_config("xhatshuffle_iter_step",
                           "candidates per sync", int, 4)

    def slama_args(self):
        self.add_to_config("slammax", "use slam-max heuristic spoke", bool,
                           False)
        self.add_to_config("slammin", "use slam-min heuristic spoke", bool,
                           False)

    def multistage(self):
        """ref:config.py:315-330."""
        self.add_to_config("branching_factors",
                           "branching factors per stage", list, None)

    def device_args(self):
        """The device every tensor of the run lives on."""
        self.add_to_config("device",
                           "torch device of the run: cuda (the default; "
                           "raises without CUDA) or cpu", str, "cuda")

    def checker(self):
        """Cross-option validation (ref:config.py:143-157)."""
        if self.get("smoothed") and self.get("defaultPHp", 0.0) < 0:
            raise ValueError("smoothing needs defaultPHp >= 0")

    # -- argparse bridge (ref:config.py:1014-1048) ------------------------
    def create_parser(self, progname: str | None = None):
        parser = argparse.ArgumentParser(prog=progname)
        for e in self._entries.values():
            if not e.argparse:
                continue
            flag = "--" + e.name.replace("_", "-")
            if e.domain is bool:
                parser.add_argument(flag, dest=e.name, nargs="?",
                                    const=True, default=e.default,
                                    type=_boolify, help=e.description)
            elif e.domain is list:
                parser.add_argument(flag, dest=e.name, nargs="+",
                                    default=e.default, type=int,
                                    help=e.description)
            else:
                parser.add_argument(flag, dest=e.name, default=e.default,
                                    type=e.domain or str,
                                    help=e.description)
        return parser

    def parse_command_line(self, progname: str | None = None, args=None):
        parser = self.create_parser(progname)
        ns = parser.parse_args(args)
        for k, v in vars(ns).items():
            if k in self._entries:
                self._entries[k].value = v
        return ns
