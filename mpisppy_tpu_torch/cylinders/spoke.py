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
#   lagranger_bounder.py:18+     -> LagrangerOuterBound   (consumes x, own W)
#   subgradient_bounder.py:12-54 -> SubgradientOuterBound (self-contained)
#   reduced_costs_spoke.py:16    -> ReducedCostsSpoke     (bound + rcs)
#   ph_ob.py:21-175              -> PhOuterBound          (own PH, small rho)
#   opt/ef.py as a cylinder      -> EFOuterBound, EFXhatInnerBound
#   xhatxbar_bounder.py:37       -> XhatXbarInnerBound
#   xhatshufflelooper_bounder.py -> XhatShuffleInnerBound
#   xhatlooper_bounder.py:23     -> XhatLooperInnerBound
#   xhatspecific_bounder.py:25   -> XhatSpecificInnerBound
#   lshaped_bounder.py:14        -> XhatLShapedInnerBound
#   slam_heuristic.py:25-129     -> SlamMaxHeuristic/SlamMinHeuristic
#   fwph_spoke.py:11-39          -> FWPHOuterBound (one FWPH iteration
#                                   per sync)
#   cross_scen_spoke.py:17-303   -> CrossScenarioCutSpoke (cuts, no bound)
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
from mpisppy_tpu_torch.ops import boxqp, pdhg


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

    def checkpoint_extras(self) -> dict:
        """The rescue countdown, so a restored wheel rescues when the
        uninterrupted one would (hub checkpoint extras)."""
        return {"dry_harvests": np.asarray(self._dry_harvests, np.int64)}

    def restore_extras(self, extras: dict) -> None:
        if "dry_harvests" in extras:
            self._dry_harvests = int(extras["dry_harvests"])

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


class XhatLooperInnerBound(XhatShuffleInnerBound):
    """Fixed-order looper: the first `scen_limit` scenarios per sync in
    SCENARIO ORDER, no shuffle (ref:mpisppy/cylinders/
    xhatlooper_bounder.py:23; the same (k·S) evaluation, identity
    permutation)."""

    def __init__(self, opt, options=None):
        options = dict(options or {})
        options.setdefault("k", int(options.pop("scen_limit", 3)))
        super().__init__(opt, options)
        self._order = np.arange(self.batch.num_real)


class XhatSpecificInnerBound(XhatShuffleInnerBound):
    """Evaluates USER-NAMED candidate scenarios' first stages
    (ref:mpisppy/cylinders/xhatspecific_bounder.py:25).  options:
    'scenario_names' (looked up in the hub driver's scenario_names) or
    'scenario_ids'."""

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        ids = self.options.get("scenario_ids")
        if ids is None:
            names = self.options.get("scenario_names")
            if names is None:
                raise ValueError("XhatSpecificInnerBound needs "
                                 "'scenario_ids' or 'scenario_names'")
            lookup = {nm: i for i, nm in enumerate(
                getattr(opt, "scenario_names", []))}
            ids = [lookup[nm] for nm in names]
        self._ids = [int(i) for i in ids]

    def update(self, hub_payload):
        self._pending = xhat_mod.xhat_shuffle(
            self.batch, hub_payload["nonants"], self._ids, len(self._ids),
            self.pdhg_opts)


class XhatLShapedInnerBound(XhatXbarInnerBound):
    """Evaluates the L-shaped master's candidate x̂ as an inner bound
    (ref:mpisppy/cylinders/lshaped_bounder.py:14): the hub publishes its
    candidate as x̄, fixed and evaluated as in the x̂-x̄ spoke."""


class LagrangerOuterBound(OuterBoundSpoke):
    """Takes the hub's x and keeps its own W from a rho schedule
    (ref:cylinders/lagranger_bounder.py:18+).  rho_rescale_factors:
    {iter: factor} applied multiplicatively when the hub iter passes."""

    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self.rho = float(self.options.get("rho", 1.0))
        self.rescale = dict(self.options.get("rho_rescale_factors", {}))
        self._W = None

    def update(self, hub_payload):
        it = hub_payload.get("iter", 0)
        if it in self.rescale:
            self.rho *= float(self.rescale.pop(it))
        dW = self.rho * (hub_payload["nonants"] - hub_payload["xbar_scen"])
        self._W = dW if self._W is None else self._W + dW
        self._pending = lag_mod.lagrangian_bound(self.batch, self._W,
                                                 self.pdhg_opts)


class SubgradientOuterBound(OuterBoundSpoke):
    """A self-contained subgradient loop, one step per hub sync
    (ref:cylinders/subgradient_bounder.py:12-54); best_bound folds only
    certified bounds (algos/lagrangian.subgradient_step)."""

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self.rho = torch.tensor(float(self.options.get("rho", 1.0)),
                                dtype=self.batch.qp.c.dtype,
                                device=self.batch.device)
        self.n_windows = int(self.options.get("n_windows", 20))
        self._st = lag_mod.subgradient_init(self.batch, self.pdhg_opts)

    def update(self, hub_payload):
        self._st = lag_mod.subgradient_step(
            self.batch, self._st, self.rho, self.pdhg_opts, self.n_windows)
        self._pending = self._st

    def harvest(self):
        if self._pending is None:
            return None
        self._offer_outer(float(self._pending.best_bound))
        return self.bound


class ReducedCostsSpoke(LagrangianOuterBound):
    """A Lagrangian bound spoke that also extracts nonant reduced costs
    for the hub's ReducedCostsFixer
    (ref:mpisppy/cylinders/reduced_costs_spoke.py:16-175).  Publishes,
    besides the bound, `rc_global` (N,) expected reduced costs — NaN where
    the scenarios disagree (x̄ variance above sqrt(bound_tol)) or x̄ sits
    away from both bounds — and `rc_scenario` (S, N), the whole scenario
    axis on a sharded batch."""

    converger_spoke_char = "R"

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        if self.batch.tree.num_nodes != 1:
            raise RuntimeError("ReducedCostsSpoke supports two-stage "
                               "problems only")
        self.bound_tol = float(self.options.get("rc_bound_tol", 1e-6))
        self.consensus_threshold = float(np.sqrt(self.bound_tol))
        self.rc_global: np.ndarray | None = None
        self.rc_scenario: np.ndarray | None = None
        self.new_rc = False
        self._nonant_lb, self._nonant_ub = self.batch.nonant_box()

    def update(self, hub_payload):
        super().update(hub_payload)
        res = self._pending
        self._rc_dev = lag_mod.nonant_reduced_costs(
            self.batch, hub_payload["W"], res.solver)
        self._x_dev = self.batch.nonants(res.solver.x)

    def harvest(self):
        b = super().harvest()
        if self._pending is None or not bool(self._pending.certified):
            # an unconverged solve has arbitrary-sign reduced costs
            return b
        # the certified bound of the SAME solve the rcs come from: the
        # fixer's bound-tightening gap needs it
        self.last_lagrangian_bound = float(self._pending.bound)
        # the GLOBAL rows (one all-gather on a sharded batch): every rank
        # publishes the same rc_global, reduced over the whole axis
        rc, x, p = (a.astype(np.float64) for a in self.batch.scen_host(
            self._rc_dev, self._x_dev, self.batch.p))            # (S, N)
        xbar = (p[:, None] * x).sum(0)
        var = (p[:, None] * x * x).sum(0) - xbar * xbar
        self.rc_scenario = rc
        exp_rc = (p[:, None] * rc).sum(0)
        at_bound = (xbar - self._nonant_lb <= self.bound_tol) \
            | (self._nonant_ub - xbar <= self.bound_tol)
        consensus = var <= self.consensus_threshold ** 2
        self.rc_global = np.where(consensus & at_bound, exp_rc, np.nan)
        self.new_rc = True
        return b


class PhOuterBound(OuterBoundSpoke):
    """PH itself as an outer-bound engine (ref:mpisppy/cylinders/
    ph_ob.py:21-175): its OWN PH iterations at a rescaled (smaller) rho,
    each followed by the Lagrangian bound at its own W — valid because
    PH's W update keeps the node mean of W at zero."""

    converger_spoke_char = "P"

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        from mpisppy_tpu_torch.algos import ph as ph_mod
        self._ph_mod = ph_mod
        rho = float(self.options.get("rho", 1.0)) \
            * float(self.options.get("ph_ob_rho_rescale", 0.1))
        self._ph_opts = ph_mod.PHOptions(
            default_rho=rho,
            subproblem_windows=int(self.options.get("n_windows", 8)),
            pdhg=self.pdhg_opts)
        self._rho = torch.full((self.batch.num_nonants,), rho,
                               dtype=self.batch.qp.c.dtype,
                               device=self.batch.device)
        self._st = None

    def update(self, hub_payload):
        if self._st is None:
            self._st, _, _ = self._ph_mod.ph_iter0(self.batch, self._rho,
                                                   self._ph_opts)
        else:
            self._st = self._ph_mod.ph_iterk(self.batch, self._st,
                                             self._ph_opts)
        self._pending = lag_mod.lagrangian_bound(
            self.batch, self._st.W, self.pdhg_opts,
            self._pending.solver if self._pending is not None else None)


def _build_ef(spoke):
    efp = spoke.options.get("ef_problem")
    if efp is None:
        from mpisppy_tpu_torch.algos.ef import build_ef
        efp = build_ef(spoke.options["specs"],
                       tree=spoke.options.get("tree"),
                       device=spoke.batch.device)
    return efp


class EFOuterBound(OuterBoundSpoke):
    """A warm PDHG solve of the ASSEMBLED extensive form, publishing its
    Fenchel dual value under a dual-residual certificate: an exact
    outer bound for LPs where PH's W converges too slowly for the
    Lagrangian plane (ref:mpisppy/opt/ef.py:16-155 as a cylinder).
    options: 'ef_problem' (algos.ef.EFProblem) or 'specs' + 'tree';
    'n_windows' per sync (default 20)."""

    converger_spoke_char = "E"

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        self.efp = _build_ef(self)
        self._qp = boxqp.one_problem(self.efp.qp)
        self.n_windows = int(self.options.get("n_windows", 20))
        self._st = pdhg.init_state(self._qp, self.pdhg_opts)

    def update(self, hub_payload):
        self._st = pdhg.solve_fixed(self._qp, self.n_windows,
                                    self.pdhg_opts, self._st)
        self._pending = self._st

    def harvest(self):
        if self._pending is None:
            return self.bound
        st = self._pending
        dual = float(boxqp.dual_objective(self._qp, st.x, st.y)[0])
        _, rd, _ = boxqp.kkt_residuals(self._qp, st.x, st.y)
        tol = max(self.pdhg_opts.tol, 5.0e-7)
        if float(rd[0]) <= 10.0 * tol and (self.bound is None
                                           or dual > self.bound):
            self.bound = dual
        return self.bound


def _ef_root_fixed_solve(qp, cols, xs, st, windows, opts):
    """n windows of the (one-problem) EF with the root columns `cols`
    fixed at `xs`; returns (state, obj, comp, rp, dead) for the one
    problem."""
    l, u = qp.l.clone(), qp.u.clone()  # noqa: E741
    l[..., cols] = xs
    u[..., cols] = xs
    qp2 = dataclasses.replace(qp, l=l, u=u)
    st = dataclasses.replace(st, x=torch.clamp(st.x, l, u))
    st = pdhg.solve_fixed(qp2, windows, opts, st)
    obj = torch.sum(qp2.c * st.x + 0.5 * qp2.q * st.x * st.x, dim=-1)
    viol = boxqp.primal_residual(qp2, st.x)
    # safety-scaled first-order compensation (xhat.COMP_SAFETY): the
    # dual iterate is truncated, so obj + comp is APPROXIMATELY certified
    comp = xhat_mod.COMP_SAFETY * torch.sum(torch.abs(st.y) * viol, dim=-1)
    rp, _, _ = boxqp.kkt_residuals(qp2, st.x, st.y)
    dead = (st.status == pdhg.INFEASIBLE) | (st.status == pdhg.UNBOUNDED)
    return st, obj[0], comp[0], rp[0], dead[0]


class EFXhatInnerBound(InnerBoundSpoke):
    """Multistage-correct x̂ inner bound: fix only the ROOT-stage nonants
    at the candidate and solve the extensive form over the remaining
    stages, so inner-node decisions re-optimize under the EF's
    nonanticipativity rows (the reference's xhatlooper `stage2ef`,
    ref:examples/hydro/hydro_cylinders.py:35).  A candidate that fixes
    EVERY stage is structurally infeasible whenever a later-stage
    equality couples nonants with stage randomness.

    Publication: obj + COMP_SAFETY*|y|'viol once the primal residual
    clears feas_tol AND the compensation is below comp_tol*|obj|.  The
    candidate root stays FROZEN across syncs until it publishes (the
    warm EF solve accumulates), and a fresh one is adopted after
    `give_up` syncs without a publication or at once when the
    root-fixed EF is certified infeasible."""

    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)
    converger_spoke_char = "I"

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        from mpisppy_tpu_torch.algos.ef import root_fix_columns
        self.efp = _build_ef(self)
        self._qp = boxqp.one_problem(self.efp.qp)
        self.n_windows = int(self.options.get("n_windows", 20))
        # rp gates how far the first-order compensation can be trusted;
        # comp_tol is the tightness gate
        self.feas_tol = float(self.options.get("feas_tol", 1e-3))
        self.comp_tol = float(self.options.get("comp_tol", 2e-3))
        self.give_up = int(self.options.get("give_up", 15))
        self._root_slots, flat, d_flat = root_fix_columns(self.efp)
        dev = self.batch.device
        self._cols = torch.as_tensor(flat, device=dev)
        self._dcols = torch.as_tensor(d_flat, dtype=self._qp.c.dtype,
                                      device=dev)
        self.pdhg_opts = dataclasses.replace(self.pdhg_opts,
                                             detect_infeas=True)
        self._st = pdhg.init_state(self._qp, self.pdhg_opts)
        self._frozen = None
        self._published = False
        self._dry_syncs = 0

    def update(self, hub_payload):
        cand = xhat_mod.round_integers(self.batch, hub_payload["xbar_nodes"])
        root = cand[0, torch.as_tensor(self._root_slots,
                                       device=cand.device)]
        if (self._frozen is None or self._published
                or self._dry_syncs >= self.give_up):
            self._frozen = root
            self._published = False
            self._dry_syncs = 0
        else:
            self._dry_syncs += 1
        xs = self._frozen.repeat(len(self.efp.probs)) / self._dcols
        self._st, obj, comp, rp, dead = _ef_root_fixed_solve(
            self._qp, self._cols, xs, self._st, self.n_windows,
            self.pdhg_opts)
        self._pending = (obj, comp, rp, dead)

    def _policy_nodes(self) -> torch.Tensor:
        """(num_nodes, N) nonanticipative policy from the EF solution:
        per-node probability-weighted averages, the root pinned at the
        frozen candidate."""
        efp = self.efp
        x = self._st.x[0].cpu().numpy() * np.asarray(efp.scaling.d_col)
        S, n = len(efp.probs), efp.n_per_scen
        xs = x.reshape(S, n)[:, np.asarray(efp.nonant_idx)]  # (S, N)
        nos = efp.tree.node_of_slot()                       # (S, N)
        p = np.asarray(efp.probs)
        N = xs.shape[1]
        nodes = np.zeros((efp.tree.num_nodes, N))
        wsum = np.zeros((efp.tree.num_nodes, N))
        colix = np.broadcast_to(np.arange(N)[None, :], (S, N))
        np.add.at(nodes, (nos, colix), p[:, None] * xs)
        np.add.at(wsum, (nos, colix), np.broadcast_to(p[:, None], (S, N)))
        nodes = nodes / np.maximum(wsum, 1e-30)
        nodes[0, self._root_slots] = self._frozen.cpu().numpy()
        return torch.as_tensor(nodes)

    def harvest(self):
        if self._pending is None:
            return self.bound
        obj, comp, rp, dead = (float(v) for v in self._pending)
        if dead > 0.5:
            # the root-fixed EF is certified infeasible or unbounded at
            # this candidate: drop it now
            self._dry_syncs = self.give_up
            return self.bound
        if rp <= self.feas_tol and comp <= self.comp_tol * max(1.0,
                                                               abs(obj)):
            self._published = True
            self._offer(obj + comp, self._policy_nodes())
        return self.bound


class CrossScenarioCutSpoke(Spoke):
    """Cross-scenario L-shaped cut generator
    (ref:mpisppy/cylinders/cross_scen_spoke.py:17-303): from the hub's
    nonants it picks the scenario x farthest from x̄, solves every
    scenario's recourse there in one batched solve, and leaves a cut
    package (dual-certified optimality cuts, Farkas feasibility cuts)
    for the hub's CrossScenarioExtension.  It publishes no bound."""

    converger_spoke_types = ()

    def __init__(self, opt, options=None):
        super().__init__(opt, options)
        # cuts are generated on the ORIGINAL (un-augmented) batch
        self.orig_batch = getattr(opt, "_cross_scen_orig_batch", opt.batch)
        # cut solves detect infeasibility and may run to convergence
        self.cut_opts = dataclasses.replace(
            self.pdhg_opts, detect_infeas=True,
            max_iters=max(self.pdhg_opts.max_iters, 100_000))
        self.cut_package: dict | None = None
        self.new_cuts = False

    def update(self, hub_payload):
        from mpisppy_tpu_torch.algos import cross_scen
        self._pending = cross_scen.launch_cuts(
            self.orig_batch, hub_payload["nonants"],
            hub_payload["xbar_scen"], self.cut_opts)

    def harvest(self):
        from mpisppy_tpu_torch.algos import cross_scen
        if self._pending is None:
            return None
        self.cut_package = cross_scen.package_cuts(self._pending,
                                                   self.cut_opts)
        self.new_cuts = True
        self._pending = None
        return None  # no bound
