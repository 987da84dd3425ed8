###############################################################################
# RollingDriver (port of mpisppy_tpu/mpc/driver.py).
#
# One receding-horizon step = one fused cylinder wheel built through the
# CLI's recipe surface (generic_cylinders._parse_args / build_wheel),
# with the previous step's shifted W/x̄ plane seeded into the hub at its
# first sync (cylinders/hub.py, options['warm_plane']: the WXBarReader
# timing without the file round-trip).  The driver's job is the per-step
# policy around that wheel:
#
#   warm attempt     solve window k from the shifted plane to the
#                    per-step gap target within the step's iteration
#                    budget (--max-iterations: a stalled step EXHAUSTS
#                    it, never hangs);
#   cold fallback    if the warm attempt misses the target (gap stall) or
#                    poisons the bounds (an infeasible shifted iterate ->
#                    a non-finite gap), re-solve the SAME window cold:
#                    the plane is a hint, never a correctness input;
#   StepDegraded     if the cold solve ALSO misses, the step is typed
#                    degraded (recorded on the StepResult; strict=True
#                    raises) and the stream continues: one hard window
#                    must not stop a control loop.
#
# Window k's data is a function of {base_seed, k} alone (horizon.py), and
# the warm plane of window k-1's converged state (shift.py), so re-running
# step k from a saved plane reproduces the stream's per-step bounds.  The
# plane travels between windows as host numpy arrays.
###############################################################################
from __future__ import annotations

import dataclasses
import importlib
import math
import time

import numpy as np


class StepDegraded(RuntimeError):
    """Window `step` missed the per-step gap target warm AND cold: the
    stream continues on the best iterate, typed for strict callers."""

    def __init__(self, step: int, rel_gap: float, target: float):
        super().__init__(
            f"mpc step {step}: rel_gap {rel_gap:.3e} missed target "
            f"{target:.3e} after cold fallback")
        self.step = step
        self.rel_gap = rel_gap
        self.target = target


@dataclasses.dataclass
class StepResult:
    """One solved window."""

    step: int
    outer: float
    inner: float
    rel_gap: float
    iterations: int
    warm: bool                 # solved from a shifted plane
    cold_fallback: bool        # warm attempt discarded, re-solved cold
    degraded: bool             # missed the gap target even cold
    solve_seconds: float
    x_root: np.ndarray         # stage-1 nonants of the incumbent
    plane: dict                # end-of-step {W, xbar_nodes, x} (UNshifted)


def _step_ok(rel_gap: float, target: float) -> bool:
    return math.isfinite(rel_gap) and rel_gap <= target + 1e-12


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class RollingDriver:
    """The receding-horizon loop over one HorizonSpec.  Every window runs
    on `device` (passed to the CLI as --device; default: the argv's, else
    CUDA)."""

    def __init__(self, horizon, hub_options: dict | None = None,
                 device=None):
        self.horizon = horizon
        #: extra hub options every window gets
        self.hub_options = dict(hub_options or {})
        self.device = device
        argv = horizon.base_argv
        self._module_name = argv[argv.index("--module-name") + 1]
        self._module = importlib.import_module(self._module_name)

    # -- one window -----------------------------------------------------
    def _spin(self, step: int, warm_plane: dict | None):
        from mpisppy_tpu_torch import generic_cylinders as gc
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
        argv = self.horizon.step_argv(step)
        if self.device is not None:
            argv += ["--device", str(self.device)]
        cfg = gc._parse_args(self._module, argv)
        hub, spokes, _names, _specs, _batch = gc.build_wheel(
            cfg, self._module)
        hub = dict(hub)
        hub["hub_kwargs"] = dict(hub.get("hub_kwargs", {}))
        hub_opts = dict(hub["hub_kwargs"].get("options", {}))
        hub_opts.update(self.hub_options)
        if warm_plane is not None:
            hub_opts["warm_plane"] = warm_plane
        hub["hub_kwargs"]["options"] = hub_opts
        wheel = WheelSpinner(hub, spokes)
        wheel.build()
        t0 = time.perf_counter()
        wheel.spin()
        dt = time.perf_counter() - t0
        _abs_gap, rel_gap = wheel.spcomm.compute_gaps()
        opt = wheel.opt
        st = opt.state
        plane = {
            "W": _host(st.W),
            "xbar_nodes": _host(st.xbar_nodes),
            "x": _host(opt.batch.nonants(st.solver.x)),
        }
        nodes = wheel.spcomm.best_nonants()
        root = np.asarray(nodes[0])[
            np.asarray(opt.batch.tree.slot_stage) == 1]
        return {
            "outer": float(wheel.BestOuterBound),
            "inner": float(wheel.BestInnerBound),
            "rel_gap": float(rel_gap),
            "iterations": int(wheel.spcomm._iter),
            "solve_seconds": dt,
            "x_root": root,
            "plane": plane,
        }

    def run_step(self, step: int, warm_plane: dict | None = None,
                 strict: bool = False) -> StepResult:
        """Solve window `step`, warm from `warm_plane` when given, with
        the cold fallback and the degraded typing of the module header."""
        warm = warm_plane is not None
        out = self._spin(step, warm_plane)
        cold_fallback = False
        if warm and not _step_ok(out["rel_gap"], self.horizon.gap_target):
            cold_fallback = True
            out = self._spin(step, None)
        degraded = not _step_ok(out["rel_gap"], self.horizon.gap_target)
        if degraded and strict:
            raise StepDegraded(step, out["rel_gap"],
                               self.horizon.gap_target)
        return StepResult(
            step=step, outer=out["outer"], inner=out["inner"],
            rel_gap=out["rel_gap"], iterations=out["iterations"],
            warm=warm and not cold_fallback,
            cold_fallback=cold_fallback, degraded=degraded,
            solve_seconds=out["solve_seconds"],
            x_root=out["x_root"], plane=out["plane"])

    # -- the stream -----------------------------------------------------
    def next_plane(self, result: StepResult) -> dict:
        """The warm plane for result.step + 1 (the shift over the
        end-of-step plane)."""
        from mpisppy_tpu_torch.mpc.shift import shift_warm_plane
        return shift_warm_plane(result.plane, self.horizon.plan)

    def stream(self, num_steps: int, start: int = 0,
               warm_plane: dict | None = None):
        """Yield StepResults for windows start .. start+num_steps-1,
        rolling the plane between them.  `warm_plane` resumes a saved
        stream; step `start` solves cold when it is None."""
        plane = warm_plane
        for k in range(start, start + num_steps):
            res = self.run_step(k, warm_plane=plane)
            plane = self.next_plane(res)
            yield res
