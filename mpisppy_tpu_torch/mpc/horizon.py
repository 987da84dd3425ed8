###############################################################################
# Declarative rolling horizons (port of mpisppy_tpu/mpc/horizon.py).
#
# A HorizonSpec is the whole receding-horizon contract as data: how wide
# the decision window is, how far it advances per step, how the previous
# step's warm plane rolls forward (a ShiftPlan), and which argv solves
# one window, so RollingDriver (driver.py) needs no loop of its own per
# model.
#
# The per-step DATA shift is the model's job, keyed by one CLI flag
# (`--uc-mpc-step k` / `--ccopf-mpc-step k`): the model hooks re-key
# every stochastic draw from the step (uc's AR(1) demand through
# fold_in(base, step); ccopf's branch multipliers) and roll the
# deterministic data (uc's demand profile; ccopf's load drift) by
# stride*step, so window k is reproducible from {base_seed, k} alone —
# the property the serve stream's preemption resume leans on
# (mpc/stream.py).  horizon_for bridges a streaming serve SubmitRequest
# to its HorizonSpec.
#
# One departure from the JAX package: ccopf_horizon's recipe stops only
# on the gap (--convthresh 0).  With the CLI's default convthresh a warm
# window stopped at hub iteration 2, its x̂ bound not yet landed: the
# seeded x̄ leaves ||x - x̄|| ~1e-7 at once (ROADMAP C1).
###############################################################################
from __future__ import annotations

import dataclasses

from mpisppy_tpu_torch.mpc.shift import ShiftPlan, ccopf_plan, uc_plan


@dataclasses.dataclass(frozen=True)
class HorizonSpec:
    """One rolling horizon, declaratively.

    window:     decision slots per solve along the rolled axis (hours
                for uc, stages for ccopf).
    stride:     slots the window advances per step.
    plan:       how W/x̄/x roll forward between steps (shift.py).
    base_argv:  the generic_cylinders argv solving ONE window (module,
                scale, recipe, rho policy: everything but the step).
    step_flag:  the model's step flag; step_argv(k) appends it, and the
                model hook shifts data and re-keys sampling from k.
    """

    name: str
    model: str
    window: int
    stride: int
    plan: ShiftPlan
    base_argv: tuple
    step_flag: str
    gap_target: float = 0.01
    max_step_iterations: int = 200

    def __post_init__(self):
        if self.window < 1 or not (0 < self.stride <= self.window):
            raise ValueError(
                f"bad horizon: window={self.window} stride={self.stride}")
        object.__setattr__(self, "base_argv", tuple(self.base_argv))

    def step_argv(self, step: int) -> list:
        """The argv solving window `step` (absolute, 0-based)."""
        if step < 0:
            raise ValueError(f"step {step} must be >= 0")
        return list(self.base_argv) + [self.step_flag, str(step)]


def _recipe_argv(module: str, num_scens: int, gap_target: float,
                 max_iterations: int) -> list:
    """The shared per-window solve recipe (the JAX package's serve
    session recipe minus the model args)."""
    return ["--module-name", module,
            "--num-scens", str(num_scens),
            "--fused-wheel", "--lagrangian", "--xhatxbar",
            "--rel-gap", str(gap_target),
            "--max-iterations", str(max_iterations),
            "--flight-recorder", "false"]


def uc_horizon(n_gens: int = 3, n_hours: int = 24, stride: int = 1,
               num_scens: int = 3, gap_target: float = 0.01,
               max_step_iterations: int = 200,
               extra_args: tuple = ()) -> HorizonSpec:
    """A `n_hours`-hour unit-commitment window advancing `stride`
    hour(s) per step, the AR(1) demand re-keyed per step through
    fold_in(base, step) (models/uc.py mpc_instance, _mpc_demand)."""
    argv = _recipe_argv("mpisppy_tpu_torch.models.uc", num_scens,
                        gap_target, max_step_iterations)
    argv += ["--uc-n-gens", str(n_gens), "--uc-n-hours", str(n_hours),
             "--slammax", "--sensi-rho",
             "--uc-mpc-stride", str(stride)]
    argv += list(extra_args)
    return HorizonSpec(
        name=f"uc-{n_gens}g{n_hours}h-s{stride}", model="uc",
        window=int(n_hours), stride=int(stride),
        plan=uc_plan(n_gens, n_hours, stride),
        base_argv=tuple(argv), step_flag="--uc-mpc-step",
        gap_target=float(gap_target),
        max_step_iterations=int(max_step_iterations))


def ccopf_horizon(soc: bool = True, gap_target: float = 0.01,
                  max_step_iterations: int = 200,
                  extra_args: tuple = ()) -> HorizonSpec:
    """Rolling dispatch on the 3-stage OPF tree (--soc by default: the
    conic branch-flow relaxation): each step promotes the old stage-2
    setpoints to stage 1, re-keys the branch multipliers and drifts the
    load (models/ccopf.py's mpc hooks).  The window is the 2 nonant
    stages; the stride is one decision epoch.  `extra_args` come after
    the recipe, so a later --num-scens or --branching-factors (or a
    --convthresh) wins.  The recipe stops only on the gap: the shifted
    plane makes ||x - x̄|| ~1e-7 from the first sync, so the CLI's
    default convthresh ended a warm window before its x̂ bound landed."""
    from mpisppy_tpu_torch.models import ccopf as ccopf_mod
    ng = len(ccopf_mod.grid_instance()["gens"])
    # 9 scenarios = the default (3, 3) tree's leaves
    argv = _recipe_argv("mpisppy_tpu_torch.models.ccopf", 9, gap_target,
                        max_step_iterations)
    if soc:
        argv += ["--soc"]
    argv += ["--convthresh", "0"]
    argv += list(extra_args)
    return HorizonSpec(
        name=f"ccopf-{'soc' if soc else 'dc'}", model="ccopf",
        window=2, stride=1, plan=ccopf_plan(ng),
        base_argv=tuple(argv), step_flag="--ccopf-mpc-step",
        gap_target=float(gap_target),
        max_step_iterations=int(max_step_iterations))


def horizon_for(spec) -> HorizonSpec:
    """The serve bridge: a streaming SubmitRequest (spec.mpc_steps > 0)
    to its HorizonSpec.  The session's model args ride along as
    extra_args so clients tune scale the same way non-streaming
    sessions do; uc window geometry is read back out of them because
    the ShiftPlan must match the solved window exactly."""
    args = list(spec.args)

    def _flag(name: str, default: int) -> int:
        val = default
        for i, a in enumerate(args):
            if a == name and i + 1 < len(args):
                val = int(args[i + 1])
            elif a.startswith(name + "="):
                val = int(a.split("=", 1)[1])
        return val

    def _without(name: str) -> tuple:
        """args minus a value-taking flag (both spellings) — the
        driver owns the step counter; a stray client copy would
        shadow every step with one frozen window."""
        out, skip = [], False
        for i, a in enumerate(args):
            if skip:
                skip = False
                continue
            if a == name:
                skip = i + 1 < len(args)
                continue
            if a.startswith(name + "="):
                continue
            out.append(a)
        return tuple(out)

    if spec.model == "uc":
        # the serve default stays interactive-sized (the engine's 3g/6h
        # session scale); a client asking for a 24 h horizon passes
        # --uc-n-hours 24 in spec.args
        return uc_horizon(
            n_gens=_flag("--uc-n-gens", 3),
            n_hours=_flag("--uc-n-hours", 6),
            stride=_flag("--uc-mpc-stride", 1),
            num_scens=spec.num_scens, gap_target=spec.gap_target,
            max_step_iterations=spec.max_iterations,
            extra_args=_without("--uc-mpc-step"))
    if spec.model == "ccopf":
        return ccopf_horizon(
            soc="--soc" in args, gap_target=spec.gap_target,
            max_step_iterations=spec.max_iterations,
            extra_args=tuple(a for a in _without("--ccopf-mpc-step")
                             if a != "--soc"))
    raise ValueError(
        f"model {spec.model!r} has no rolling-horizon hook "
        "(want uc or ccopf)")
