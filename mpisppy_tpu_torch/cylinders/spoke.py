###############################################################################
# Spoke taxonomy (ref:mpisppy/cylinders/spoke.py:21-380) and the fused
# bound spokes (port of the core of mpisppy_tpu/cylinders/spoke.py).
#
# A spoke consumes the hub's latest snapshot and produces a bound.  The
# fused spokes do no device work of their own: their computation rides
# inside FusedPH's iteration (algos/fused_wheel.py) and they only read
# the packed scalar cache at harvest.  The classic, separately launched
# spokes (which implement update() and harvest() against the hub's
# snapshot) are not ported yet.
###############################################################################
from __future__ import annotations

import dataclasses
import enum
import math

from mpisppy_tpu_torch.algos import xhat as xhat_mod
from mpisppy_tpu_torch.cylinders.spcommunicator import SPCommunicator
from mpisppy_tpu_torch.ops import pdhg


class ConvergerSpokeType(enum.Enum):
    """ref:mpisppy/cylinders/spoke.py:21-25."""

    OUTER_BOUND = 1
    INNER_BOUND = 2
    W_GETTER = 3
    NONANT_GETTER = 4


class Spoke(SPCommunicator):
    """Base spoke: runs against the hub's ScenarioBatch snapshot."""

    converger_spoke_types: tuple[ConvergerSpokeType, ...] = ()

    def __init__(self, opt, options: dict | None = None):
        super().__init__(opt, options)
        self.batch = opt.batch
        self.pdhg_opts = self.options.get(
            "pdhg_opts", pdhg.PDHGOptions(tol=1e-6))
        self.bound: float | None = None
        self.trace: list[tuple[int, float]] = []  # (hub_iter, bound)
        # the hub counts a strike per non-finite bound and flips
        # `disabled` after K — a disabled spoke is never read again
        self.strikes = 0
        self.disabled = False

    def update(self, hub_payload: dict):
        """Launch this spoke's computation for the hub snapshot.  Must
        not wait for device results."""
        raise NotImplementedError

    def harvest(self) -> float | None:
        """Read the latest result, update self.bound, return it."""
        raise NotImplementedError

    def main(self):  # spokes are driven by the wheel, not self-running
        pass


class OuterBoundSpoke(Spoke):
    """Outer (lower, for min) bounds — only CERTIFIED results accepted
    (ref:mpisppy/cylinders/spoke.py:250-275)."""

    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,)

    def _offer_outer(self, b: float) -> None:
        # a non-finite bound never becomes the cached best: every later
        # `b > NaN` comparison is False
        if math.isfinite(b) and (self.bound is None or b > self.bound):
            self.bound = b


class InnerBoundSpoke(Spoke):
    """Incumbent finders; keeps the best (xhat, value) pair so the
    winning solution can be written out (ref:mpisppy/cylinders/
    spoke.py:242-248,325-367).  Publication is gated on feasibility AND
    comp-tightness (xhat.comp_tight)."""

    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,)

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self.best_xhat = None  # (num_nodes, N) or (N,) candidate, numpy
        self.comp_tol = float(self.options.get(
            "comp_tol", xhat_mod.DEFAULT_COMP_TOL))

    def _offer(self, value: float, xhat) -> None:
        if not math.isfinite(value):
            return  # never cache a poisoned incumbent
        if self.bound is None or value < self.bound:
            self.bound = value
            self.best_xhat = xhat.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Fused spokes (pair with algos.fused_wheel.FusedPH).  `fused = True`
# makes the hub harvest them every iteration (they cost a dict lookup).
# ---------------------------------------------------------------------------
class FusedLagrangianOuterBound(OuterBoundSpoke):
    """Reads the in-step Lagrangian bound off the scalar cache — the
    fused analog of LagrangianOuterBound (same certificate gating)."""

    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.W_GETTER)
    converger_spoke_char = "L"
    fused = True

    def update(self, hub_payload):
        pass  # computation rides inside FusedPH's step

    def harvest(self):
        sc = getattr(self.opt, "scalar_cache", None)
        if sc is None:
            return self.bound
        if sc["lag_certified"] > 0.5:
            self._offer_outer(sc["lag_bound"])
        return self.bound


class FusedXhatXbarInnerBound(InnerBoundSpoke):
    """Reads the in-step x̂ = round(x̄) recourse value off the scalar
    cache — the fused analog of XhatXbarInnerBound.

    Fallback: if the truncated in-loop evaluation has not produced a
    feasible value for `rescue_after` consecutive harvests, one blocking
    warm evaluation with the rescue tiers runs at harvest."""

    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)
    converger_spoke_char = "X"
    fused = True

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self.rescue_after = int(self.options.get("rescue_after", 40))
        self._dry_harvests = 0

    def update(self, hub_payload):
        pass

    def harvest(self):
        sc = getattr(self.opt, "scalar_cache", None)
        if sc is None:
            return self.bound
        if sc["xhat_feasible"] > 0.5:
            self._dry_harvests = 0
            # cand_cache rides the same pipeline as scalar_cache, so the
            # value is always paired with the candidate it was evaluated
            # at; the tensor transfers only on an actual offer
            if self.bound is None or sc["xhat_value"] < self.bound:
                self._offer(sc["xhat_value"], self.opt.cand_cache["xhat"])
            return self.bound
        self._dry_harvests += 1
        if self._dry_harvests >= self.rescue_after:
            self._dry_harvests = 0
            if sc.get("xhat_dead", 0.0) > 0.5:
                # the candidate is CERTIFIED recourse-infeasible; the
                # plane is already rotating to a new one
                return self.bound
            cand = self.opt.cand_cache["xhat"]
            # warm rescue from the in-loop plane's solver state, folded
            # back so the plane keeps the benefit
            wstate = getattr(self.opt, "wstate", None)
            if wstate is not None:
                res, st = xhat_mod.evaluate_warm(
                    self.batch, cand, wstate.xhat_solver, self.pdhg_opts)
                self.opt.wstate = dataclasses.replace(wstate,
                                                      xhat_solver=st)
            else:
                res = xhat_mod.evaluate(self.batch, cand, self.pdhg_opts)
            if bool(res.feasible) and xhat_mod.comp_tight(
                    self.batch, res, self.comp_tol):
                self._offer(float(res.value), cand)
        return self.bound
