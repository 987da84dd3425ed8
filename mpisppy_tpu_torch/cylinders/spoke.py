###############################################################################
# Spoke taxonomy (ref:mpisppy/cylinders/spoke.py:21-380) and the bound
# spokes the generic driver maps (port of mpisppy_tpu/cylinders/spoke.py).
#
# A spoke consumes the hub's latest snapshot and produces a bound.  The
# fused spokes do no device work of their own: their computation rides
# inside FusedPH's iteration (algos/fused_wheel.py) and they only read
# the packed scalar cache at harvest.  The classic spokes launch a
# batched solve over the hub's batch in update() and leave its result in
# `_pending`; harvest() reads it (inner bounds first pass it through
# `_finalize`, which runs the stalled-tail rescue).  Here update() runs
# its solve to the end: pdhg.solve reads `all(done)` once per window.
#
# Spoke map (ref file -> class here):
#   lagrangian_bounder.py:53-98  -> LagrangianOuterBound  (consumes W)
#   xhatxbar_bounder.py:37       -> XhatXbarInnerBound
#   xhatshufflelooper_bounder.py -> XhatShuffleInnerBound
#   slam_heuristic.py:25-129     -> SlamMaxHeuristic/SlamMinHeuristic
#   fwph_spoke.py:11-39          -> FWPHOuterBound (one FWPH iteration
#                                   per sync)
###############################################################################
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from mpisppy_tpu_torch.algos import fwph as fwph_mod
from mpisppy_tpu_torch.algos import lagrangian as lag_mod
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
        self._pending = None  # the last launched, un-harvested result
        self.trace: list[tuple[int, float]] = []  # (hub_iter, bound)
        # the hub counts a strike per non-finite bound and flips
        # `disabled` after K — a disabled spoke is never read again
        self.strikes = 0
        self.disabled = False

    def update(self, hub_payload: dict):
        """Run this spoke's computation for the hub snapshot and leave
        its result for harvest()."""
        raise NotImplementedError

    def harvest(self) -> float | None:
        """Read the latest result, update self.bound, return it."""
        raise NotImplementedError

    def main(self):  # spokes are driven by the wheel, not self-running
        pass


class OuterBoundSpoke(Spoke):
    """Outer (lower, for min) bounds — only CERTIFIED results accepted
    (ref:mpisppy/cylinders/spoke.py:250-275).  Subclasses leave a
    LagrangianResult-like object (bound, certified) in `_pending`."""

    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,)

    def _offer_outer(self, b: float) -> None:
        # a non-finite bound never becomes the cached best: every later
        # `b > NaN` comparison is False
        if math.isfinite(b) and (self.bound is None or b > self.bound):
            self.bound = b

    def harvest(self):
        if self._pending is None:
            return None
        if bool(self._pending.certified):
            self._offer_outer(float(self._pending.bound))
        return self.bound


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

    def _finalize(self, res, xhat):
        """Applied at harvest (blocking is fine there): subclasses run
        the stalled-tail rescue, so update() stays a single solve."""
        return res

    def harvest(self):
        if self._pending is None:
            return None
        res, xhat = self._pending
        res = self._finalize(res, xhat)
        if bool(res.feasible) and xhat_mod.comp_tight(self.batch, res,
                                                      self.comp_tol):
            self._offer(float(res.value), xhat)
        return self.bound


class FWPHOuterBound(OuterBoundSpoke):
    """FWPH as an outer-bound spoke (ref:cylinders/fwph_spoke.py:11-39):
    self-contained, it advances one FWPH outer iteration per hub sync
    and publishes FWPH's best certified dual bound.  Options: `fw_opts`
    (an FWPHOptions) and `rho`."""

    converger_spoke_char = "F"

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self.fw_opts = self.options.get("fw_opts", fwph_mod.FWPHOptions())
        rho = torch.full((self.batch.num_nonants,),
                         float(self.options.get("rho",
                                                self.fw_opts.default_rho)),
                         dtype=self.batch.qp.c.dtype,
                         device=self.batch.device)
        self._st, _, _ = fwph_mod.fwph_init(self.batch, rho, self.fw_opts)

    def update(self, hub_payload):
        self._st = fwph_mod.fwph_iter(self.batch, self._st, self.fw_opts)
        self._pending = self._st

    def harvest(self):
        if self._pending is None:
            return None
        self._offer_outer(float(self._pending.best_bound))
        return self.bound


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


class FusedXhatShuffleInnerBound(InnerBoundSpoke):
    """Reads the in-step rotating-scenario candidate value off the
    scalar cache (FusedWheelOptions.shuffle_windows > 0) — the fused
    analog of XhatShuffleInnerBound: one shuffled scenario's own first
    stage per wheel iteration."""

    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)
    converger_spoke_char = "F"
    fused = True
    _plane = "shuf"

    def update(self, hub_payload):
        pass

    def harvest(self):
        sc = getattr(self.opt, "scalar_cache", None)
        if sc is None:
            return self.bound
        value = sc[f"{self._plane}_value"]
        if sc[f"{self._plane}_feasible"] > 0.5 and (
                self.bound is None or value < self.bound):
            self._offer(value, self.opt.cand_cache[self._plane])
        return self.bound


class FusedSlamHeuristic(FusedXhatShuffleInnerBound):
    """Reads the in-step slam-candidate recourse value off the scalar
    cache (FusedWheelOptions.slam_windows > 0) — the fused analog of
    SlamMaxHeuristic/SlamMinHeuristic."""

    converger_spoke_char = "S"
    _plane = "slam"


# ---------------------------------------------------------------------------
# Classic spokes: each update() runs a batched solve over the hub's batch
# at the hub's snapshot; harvest() folds the result.
# ---------------------------------------------------------------------------
class LagrangianOuterBound(OuterBoundSpoke):
    """L(W) at the hub's W (ref:cylinders/lagrangian_bounder.py:53-98),
    warm from the previous sync's solver state."""

    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.W_GETTER)

    def update(self, hub_payload):
        self._pending = lag_mod.lagrangian_bound(
            self.batch, hub_payload["W"], self.pdhg_opts,
            self._pending.solver if self._pending is not None else None)


class XhatXbarInnerBound(InnerBoundSpoke):
    """x̂ = rounded x̄ (ref:cylinders/xhatxbar_bounder.py:37), warm from
    the previous sync's recourse solve (consecutive x̄ differ little)."""

    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self._solver = None

    def update(self, hub_payload):
        # the ROUNDED candidate is cached: the bound is evaluated at it,
        # so the incumbent written out is the same point
        cand = xhat_mod.round_integers(self.batch, hub_payload["xbar_nodes"])
        if self._solver is None:
            qp = self.batch.with_fixed_nonants(cand)
            self._solver = pdhg.init_state(
                qp, dataclasses.replace(self.pdhg_opts, detect_infeas=True))
        res, self._solver = xhat_mod._evaluate_warm_core(
            self.batch, cand, self._solver, self.pdhg_opts)
        self._pending = (res, cand)

    def _finalize(self, res, xhat):
        return xhat_mod._rescue_merge(self.batch, xhat, res, self.pdhg_opts,
                                      1e-3)


class XhatShuffleInnerBound(InnerBoundSpoke):
    """A deterministic shuffle of candidate scenarios, k tried per sync
    as one (k·S)-scenario solve
    (ref:cylinders/xhatshufflelooper_bounder.py:23-157; seed 42 at :74)."""

    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self.k = int(self.options.get("k", 4))
        # reverse epochs: walk the shuffle backwards every other pass
        # (ref:xhatshufflelooper_bounder.py ScenarioCycler reverse mode)
        self.add_reversed = bool(self.options.get("add_reversed", False))
        rng = np.random.default_rng(self.options.get("seed", 42))
        self._order = rng.permutation(self.batch.num_real)
        self._cursor = 0
        self._reversed_epoch = False

    def _next_ids(self) -> list[int]:
        S = self.batch.num_real
        order = self._order[::-1] if self._reversed_epoch else self._order
        ids = [int(order[(self._cursor + j) % S]) for j in range(self.k)]
        cursor = self._cursor + self.k
        if cursor >= S and self.add_reversed:
            self._reversed_epoch = not self._reversed_epoch
        self._cursor = cursor % S
        return ids

    def update(self, hub_payload):
        self._pending = xhat_mod.xhat_shuffle(
            self.batch, hub_payload["nonants"], self._next_ids(), self.k,
            self.pdhg_opts)

    def harvest(self):
        if self._pending is None:
            return None
        vals, feas, cands, comps = self._pending
        vals = vals.cpu().numpy()
        # comp-tightness gate, batched (see InnerBoundSpoke.harvest)
        feas = feas.cpu().numpy() & xhat_mod.comp_tight_mask(
            vals, comps.cpu().numpy(), self.comp_tol)
        if feas.any():
            j = int(np.argmin(np.where(feas, vals, np.inf)))
            self._offer(float(vals[j]), cands[j])
        else:
            # every candidate failed the cold evaluation — at scale
            # usually the stalled tail, not true infeasibility; rescue-
            # evaluate candidates in order until one lands, at most 2
            # per sync
            for j in range(min(2, len(vals))):
                res = xhat_mod.evaluate(self.batch, cands[j], self.pdhg_opts)
                if bool(res.feasible) and xhat_mod.comp_tight(
                        self.batch, res, self.comp_tol):
                    self._offer(float(res.value), cands[j])
                    break
        return self.bound


class _SlamHeuristic(InnerBoundSpoke):
    sense_max = True

    def update(self, hub_payload):
        xhat = xhat_mod.slam_candidate(self.batch, hub_payload["nonants"],
                                       self.sense_max)
        self._pending = (
            xhat_mod._evaluate_core(self.batch, xhat, self.pdhg_opts, 1e-3),
            xhat)

    def _finalize(self, res, xhat):
        return xhat_mod._rescue_merge(self.batch, xhat, res, self.pdhg_opts,
                                      1e-3)


class SlamMaxHeuristic(_SlamHeuristic):
    """ref:cylinders/slam_heuristic.py:111."""

    sense_max = True


class SlamMinHeuristic(_SlamHeuristic):
    """ref:cylinders/slam_heuristic.py:121."""

    sense_max = False
