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

    def aph_args(self):
        """ref:config.py:396-430."""
        self.add_to_config("aph_hub", "use APH as the hub algorithm",
                           bool, False)
        self.add_to_config("aph_gamma", "APH gamma parameter", float, 1.0)
        self.add_to_config("aph_nu", "APH step scaling nu", float, 1.0)
        self.add_to_config("aph_dispatch_frac",
                           "fraction of subproblems dispatched per "
                           "iteration", float, 1.0)
        self.add_to_config("aph_use_dynamic_gamma",
                           "adapt gamma from the u/v norm decrease ratio",
                           bool, False)
        # the JAX package's parse-only legacy alias (the listener
        # consensus fraction has no analog in one program)
        self.add_to_config("aph_frac_needed",
                           "legacy parse-only no-op (listener consensus "
                           "fraction; use --aph-dispatch-frac)", float, 1.0)

    def lagranger_args(self):
        self.add_to_config("lagranger", "use a Lagranger bound spoke",
                           bool, False)
        self.add_to_config("lagranger_rho_rescale_factors_json",
                           "json {iter: factor}", str, None)

    def subgradient_args(self):
        self.add_to_config("subgradient", "use a subgradient bound spoke",
                           bool, False)
        self.add_to_config("subgradient_rho", "subgradient step rho",
                           float, 1.0)

    def reduced_costs_args(self):
        """ref:config.py:539-600."""
        self.add_to_config("reduced_costs",
                           "use a reduced-costs spoke + fixer", bool,
                           False)
        self.add_to_config("rc_bound_tol", "at-bound tolerance for rc "
                           "extraction", float, 1e-6)
        self.add_to_config("rc_zero_rc_tol", "zero reduced-cost "
                           "tolerance", float, 1e-4)
        self.add_to_config("rc_fix_fraction_iter0",
                           "fraction of nonants to fix after iter0",
                           float, 0.0)
        self.add_to_config("rc_fix_fraction_iterk",
                           "fraction of nonants to fix at iter k",
                           float, 0.0)
        self.add_to_config("rc_bound_tightening",
                           "tighten nonant bounds from reduced costs",
                           bool, False)

    def ph_ob_args(self):
        """ref:config.py ph_ob group."""
        self.add_to_config("ph_ob", "use a PH outer-bound spoke", bool,
                           False)
        self.add_to_config("ph_ob_rho_rescale_factor",
                           "rho rescale for the ph_ob spoke", float, 0.1)

    def cross_scenario_cuts_args(self):
        """ref:config.py cross_scenario_cuts group."""
        self.add_to_config("cross_scenario_cuts",
                           "use a cross-scenario cut spoke + hub "
                           "extension", bool, False)
        self.add_to_config("cross_scenario_iter_cnt",
                           "hub iterations between EF bound checks",
                           int, 4)
        self.add_to_config("cross_scenario_max_rounds",
                           "capacity of the preallocated cut buffer "
                           "(rounds of S cuts)", int, 8)

    def lshaped_args(self):
        """L-shaped (Benders) hub options (ref:mpisppy/opt/lshaped.py
        options dict: max_iter/tol/root_solver)."""
        self.add_to_config("lshaped_hub", "use L-shaped (Benders) as the "
                           "hub algorithm instead of PH", bool, False)
        self.add_to_config("lshaped_max_iter", "Benders iterations", int,
                           50)
        self.add_to_config("lshaped_multicut", "per-scenario cuts", bool,
                           False)
        self.add_to_config("xhatlshaped", "use an xhat-lshaped inner "
                           "spoke", bool, False)

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
        self.add_to_config("async_staleness",
                           "async wheel: exchange-plane staleness bound "
                           "(0 = synchronous hub; algos/async_wheel.py)",
                           int, 0)
        self.add_to_config("async_exchange_deadline_s",
                           "async wheel: bound (seconds) on settling an "
                           "exchange plane ticket — expiry surfaces a "
                           "typed SolveFailed instead of a hang "
                           "(0 = unbounded; the hub watchdog is then "
                           "the wedged-exchange backstop)",
                           float, 0.0)

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

    def dispatch_args(self):
        """Dispatch-scheduler knobs (dispatch/scheduler.py): the
        coalescing queue, the bounded in-flight pipeline, the
        shape-bucket discipline and the fault domain every MIP solve
        rides through."""
        self.add_to_config("dispatch_coalesce",
                           "aggregate concurrent same-shape solves "
                           "into megabatch dispatches", bool, True)
        self.add_to_config("dispatch_max_batch",
                           "lane cap per coalesced megabatch dispatch",
                           int, 4096)
        self.add_to_config("dispatch_max_wait_ms",
                           "admission window (ms) a queued solve may "
                           "wait for coalescence", float, 2.0)
        self.add_to_config("dispatch_max_inflight",
                           "outstanding device dispatches before "
                           "submitters block (2 = double buffer)",
                           int, 2)
        self.add_to_config("dispatch_pad",
                           "pad megabatches up the geometric bucket "
                           "ladder", bool, True)
        self.add_to_config("dispatch_bucket_growth",
                           "geometric growth factor of the batch "
                           "bucket ladder", float, 2.0)
        self.add_to_config("dispatch_compile_guard",
                           "raise on a compile event against an "
                           "already-warm shape signature", bool, False)
        self.add_to_config("dispatch_timeout_s",
                           "per-attempt megabatch dispatch timeout: a "
                           "hung dispatch is abandoned and retried "
                           "after this many seconds (off when unset)",
                           float, None)
        self.add_to_config("dispatch_retry_max",
                           "retries (with exponential backoff) before "
                           "a failing megabatch is bisected to isolate "
                           "and quarantine the poison request(s)",
                           int, 2)
        self.add_to_config("dispatch_retry_backoff_s",
                           "base retry backoff, doubled per retry",
                           float, 0.05)
        self.add_to_config("dispatch_deadline_s",
                           "default per-ticket deadline: result() can "
                           "never block longer; expiry raises a typed "
                           "SolveFailed (off when unset)", float, None)

    def resilience_args(self):
        """Preemption-tolerant checkpointing and the graceful-degradation
        knobs: the spoke strike policy, the PDHG per-lane divergence
        guard and the hub progress watchdog."""
        self.add_to_config("checkpoint_path",
                           "rotated wheel checkpoint file; also enables "
                           "the SIGTERM/SIGINT emergency save",
                           str, None)
        self.add_to_config("checkpoint_every_s",
                           "seconds between background checkpoints",
                           float, 60.0)
        self.add_to_config("checkpoint_keep",
                           "rotated snapshots kept (path, path.1, ...; "
                           "minimum 2)", int, 2)
        self.add_to_config("checkpoint_restore",
                           "resume from the newest valid snapshot when "
                           "one exists at checkpoint-path",
                           bool, False)
        self.add_to_config("spoke_max_strikes",
                           "auto-disable a spoke after this many "
                           "rejected (non-finite) bounds", int, 3)
        self.add_to_config("bound_slack",
                           "relative slack for sense-violation bound "
                           "rejection", float, 5e-3)
        self.add_to_config("bound_evict_contras",
                           "distinct contradicting spokes that evict a "
                           "standing incumbent bound", int, 3)
        self.add_to_config("lane_guard",
                           "quarantine-reset diverged PDHG scenario "
                           "lanes at restart boundaries", bool, False)
        self.add_to_config("guard_max_resets",
                           "bounded quarantine retries per PDHG lane",
                           int, 3)
        self.add_to_config("watchdog_budget_s",
                           "hub progress watchdog: trip when no hub "
                           "iteration or bound movement for this many "
                           "wall seconds (off when unset)", float, None)
        self.add_to_config("watchdog_action",
                           "watchdog trip action: 'abort' (flight dump "
                           "+ emergency checkpoint + exit 75) or "
                           "'degrade' (un-coalesced "
                           "direct dispatch; a second stalled budget "
                           "escalates to abort)", str, "abort")
        self.add_to_config("watchdog_interval_s",
                           "watchdog poll interval (default: a quarter "
                           "of the budget)", float, None)

    def telemetry_args(self):
        """Telemetry knobs: the structured wheel trace, the metrics
        snapshot, console verbosity, the kernel counters, the device
        profile (a torch.profiler window) and the crash flight
        recorder."""
        self.add_to_config("trace_jsonl",
                           "write structured wheel events to this JSONL "
                           "trace file", str, None)
        self.add_to_config("metrics_snapshot",
                           "Prometheus-style text metrics file, "
                           "rewritten atomically during the run", str,
                           None)
        self.add_to_config("metrics_every_s",
                           "seconds between metrics snapshot rewrites",
                           float, 30.0)
        self.add_to_config("telemetry_verbosity",
                           "console verbosity: 0 quiet, 1 progress, "
                           "2 debug", int, 1)
        self.add_to_config("kernel_counters",
                           "accumulate per-lane PDHG counters "
                           "(iterations/restarts/omega adaptations + a "
                           "score ring) at each restart boundary", bool,
                           False)
        self.add_to_config("profile_dir",
                           "bracket wheel iterations with a "
                           "torch.profiler trace written here", str, None)
        self.add_to_config("profile_iters",
                           "wheel iterations the profiler trace covers",
                           int, 5)
        self.add_to_config("flight_recorder",
                           "always-on crash black box: ring of the last "
                           "events, dumped to flight-<runid>.jsonl when "
                           "the wheel dies (disable: "
                           "--flight-recorder false)", bool, True)
        self.add_to_config("flight_capacity",
                           "events held by the flight-recorder ring",
                           int, 512)
        self.add_to_config("flight_dir",
                           "directory flight-<runid>.jsonl dumps land "
                           "in", str, ".")

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
