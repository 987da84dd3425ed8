###############################################################################
# X-hat evaluation and inner-bound heuristics (port of
# mpisppy_tpu/algos/xhat.py).
#
# Fixing a candidate first stage into every scenario and solving for the
# recourse gives E[f(xhat, xi_s)], an inner (upper, for min) bound
# (ref:mpisppy/utils/xhat_eval.py:33-400).  A candidate evaluation is
# one batched solve of the same scenario tensors with the nonant box
# collapsed to the candidate point.  The candidates: x̄ rounded
# (ref:cylinders/xhatxbar_bounder.py:37), scenarios' own first stages in
# a shuffled order (ref:cylinders/xhatshufflelooper_bounder.py:23-157),
# and every nonant slammed to its scenario max or min
# (ref:cylinders/slam_heuristic.py:25-129).
#
# The JAX package evaluates k shuffle candidates as a vmap of one
# evaluation.  Here the k candidates are one (k·S)-scenario batch whose
# block j is the batch fixed at candidate j: a shared A stays shared, so
# the whole shuffle is one window kernel launch per window.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch.core.batch import ScenarioBatch, concretize
from mpisppy_tpu_torch.ops import boxqp, pdhg

Tensor = torch.Tensor

# Safety factor on the first-order infeasibility compensation
# E[sum |y| viol]: it uses the current (truncated-solve) dual iterate,
# not a verified dual bound, so doubling it covers the inexact-dual
# slack at first order; the comp-tightness gate bounds how much of the
# value the compensation may be.  Exactly feasible solves pay zero.
COMP_SAFETY = 2.0

# Max expected compensation relative to the value a published inner
# bound may carry (fused_wheel.FusedWheelOptions.xhat_comp_tol).
DEFAULT_COMP_TOL = 2e-3


@dataclasses.dataclass(frozen=True)
class XhatResult:
    value: Tensor         # () E[f(xhat)]; +inf when infeasible
    per_scenario: Tensor  # (S,) recourse objective values
    feasible: Tensor      # () bool — every real scenario feasible at tol
    primal_resid: Tensor  # (S,) relative primal residuals
    status: Tensor        # (S,) int32 pdhg status (INFEASIBLE certified)
    comp: Tensor          # (S,) safety-scaled first-order infeasibility
    #                       compensation already INCLUDED in per_scenario


def comp_tight_mask(values, ecomps,
                    comp_tol: float = DEFAULT_COMP_TOL) -> np.ndarray:
    """Host-side publication tightness gate: finite value AND
    E[comp] <= comp_tol * max(1, |value|)."""
    values = np.asarray(values, np.float64)
    ecomps = np.asarray(ecomps, np.float64)
    return np.isfinite(values) \
        & (ecomps <= comp_tol * np.maximum(1.0, np.abs(values)))


def comp_tight(batch: ScenarioBatch, res: XhatResult,
               comp_tol: float = DEFAULT_COMP_TOL) -> bool:
    """The tightness gate applied to an evaluation result (matches the
    in-loop gate of fused_wheel._eval_step)."""
    return bool(comp_tight_mask(float(res.value),
                                float(batch.expectation(res.comp)),
                                comp_tol))


def _per_scenario(qp: boxqp.BoxQP, st: pdhg.PDHGState, feas_tol: float):
    """Compensated recourse objectives, compensations, primal residuals
    and the per-scenario feasibility test at a solver state (UNBOUNDED
    fails it too: a frozen unbounded iterate has an arbitrary finite
    objective)."""
    obj = torch.sum(qp.c * st.x + 0.5 * qp.q * st.x * st.x, dim=-1)
    comp = COMP_SAFETY * torch.sum(
        st.y.abs() * boxqp.primal_residual(qp, st.x), dim=-1)
    rp, _, _ = boxqp.kkt_residuals(qp, st.x, st.y)
    scen_ok = (rp <= feas_tol) & (st.status != pdhg.INFEASIBLE) \
        & (st.status != pdhg.UNBOUNDED)
    return obj + comp, comp, rp, scen_ok


def _result(batch: ScenarioBatch, qp: boxqp.BoxQP, st: pdhg.PDHGState,
            feas_tol: float) -> XhatResult:
    """The evaluation's result: value counts only when every real
    scenario passes the feasibility test."""
    obj, comp, rp, scen_ok = _per_scenario(qp, st, feas_tol)
    real = batch.p > 0.0
    feas = torch.all(torch.where(real, scen_ok, True))
    value = torch.where(feas, batch.expectation(obj),
                        torch.full_like(obj[0], float("inf")))
    return XhatResult(value=value, per_scenario=obj, feasible=feas,
                      primal_resid=rp, status=st.status, comp=comp)


def _evaluate_core(batch: ScenarioBatch, xhat: Tensor,
                   opts: pdhg.PDHGOptions, feas_tol: float) -> XhatResult:
    """E[f(xhat, xi_s)] from a cold solve with infeasibility detection
    (ref:mpisppy/utils/xhat_eval.py:254-340)."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    qp = batch.with_fixed_nonants(xhat)
    opts = dataclasses.replace(opts, detect_infeas=True)
    st = pdhg.solve(qp, opts, pdhg.init_state(qp, opts))
    return _result(batch, qp, st, feas_tol)


def evaluate(batch: ScenarioBatch, xhat: Tensor,
             opts: pdhg.PDHGOptions = pdhg.PDHGOptions(),
             feas_tol: float = 1e-3) -> XhatResult:
    """Cold evaluation plus the stalled-tail rescue (_rescue_merge)."""
    res = _evaluate_core(batch, xhat, opts, feas_tol)
    return _rescue_merge(batch, xhat, res, opts, feas_tol)


def evaluate_warm(batch: ScenarioBatch, xhat: Tensor,
                  solver: pdhg.PDHGState,
                  opts: pdhg.PDHGOptions = pdhg.PDHGOptions(),
                  feas_tol: float = 1e-3):
    """Evaluation warm-started from `solver` (clipped into the fixed
    box), with the same rescue as evaluate().  Returns
    (XhatResult, new_solver_state) — the primary solve's state."""
    res, st = _evaluate_warm_core(batch, xhat, solver, opts, feas_tol)
    return _rescue_merge(batch, xhat, res, opts, feas_tol), st


def _evaluate_warm_core(batch: ScenarioBatch, xhat: Tensor,
                        solver: pdhg.PDHGState,
                        opts: pdhg.PDHGOptions = pdhg.PDHGOptions(),
                        feas_tol: float = 1e-3):
    """evaluate_warm() without the rescue.  Returns
    (XhatResult, new_solver_state)."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    qp = batch.with_fixed_nonants(xhat)
    wopts = dataclasses.replace(opts, detect_infeas=True)
    st = dataclasses.replace(solver, x=torch.clamp(solver.x, qp.l, qp.u))
    st = pdhg.solve(qp, wopts, st)
    return _result(batch, qp, st, feas_tol), st


def _scen_ok(res: XhatResult, feas_tol: float) -> Tensor:
    return (res.primal_resid <= feas_tol) \
        & (res.status != pdhg.INFEASIBLE) \
        & (res.status != pdhg.UNBOUNDED)


# (omega0, restart_period, max_iters multiplier) rescue tiers, tried in
# order until every real scenario clears tolerance
_RESCUE_TIERS = ((0.1, 80, 3), (0.03, 160, 8))


def _rescue_merge(batch: ScenarioBatch, xhat: Tensor, res: XhatResult,
                  opts: pdhg.PDHGOptions, feas_tol: float) -> XhatResult:
    """Re-solve unconverged scenarios at the rescue profiles and keep
    each scenario's better result.  Reads device results (blocking)."""
    if bool(res.feasible):
        return res
    ok = _scen_ok(res, feas_tol)
    per, rp, status, comp = (res.per_scenario, res.primal_resid,
                             res.status, res.comp)
    real = batch.p > 0.0
    # a certified Farkas/recession status cannot improve: skip the
    # rescue when only certified-infeasible scenarios fail
    rescueable = real & ~ok & (status != pdhg.INFEASIBLE) \
        & (status != pdhg.UNBOUNDED)
    if not bool(torch.any(rescueable)):
        return res
    for om, rper, mul in _RESCUE_TIERS:
        rescue = dataclasses.replace(
            opts, omega0=om, restart_period=rper,
            max_iters=min(mul * opts.max_iters, 60_000))
        r2 = _evaluate_core(batch, xhat, rescue, feas_tol)
        ok2 = _scen_ok(r2, feas_tol)
        # adopt the rescue's result only where it actually converged
        newly = ~ok & ok2
        per = torch.where(newly, r2.per_scenario, per)
        rp = torch.where(newly, r2.primal_resid, rp)
        status = torch.where(newly, r2.status, status)
        comp = torch.where(newly, r2.comp, comp)
        ok = ok | ok2
        if bool(torch.all(torch.where(real, ok, True))):
            break
    feas = torch.all(torch.where(real, ok, True))
    value = torch.where(feas, batch.expectation(per),
                        torch.full_like(per[0], float("inf")))
    return XhatResult(value=value, per_scenario=per, feasible=feas,
                      primal_resid=rp, status=status, comp=comp)


def round_integers(batch: ScenarioBatch, xhat: Tensor,
                   mode: str = "nearest") -> Tensor:
    """Round integer nonant slots (ref:mpisppy/extensions/xhatxbar.py).
    "ceil"/"floor" are the fused x̄ plane's escalation tiers (with a
    1e-2 dust guard against float noise in x̄)."""
    if mode == "nearest":
        rounded = torch.round(xhat)
    elif mode == "ceil":
        rounded = torch.ceil(xhat - 1e-2)
    elif mode == "floor":
        rounded = torch.floor(xhat + 1e-2)
    else:
        raise ValueError(f"unknown rounding mode: {mode}")
    return torch.where(batch.integer_slot, rounded, xhat)


def xhat_xbar(batch: ScenarioBatch, xbar_nodes: Tensor,
              opts: pdhg.PDHGOptions = pdhg.PDHGOptions()) -> XhatResult:
    """Try x̂ = x̄ (integers rounded) — the XhatXbar inner bound
    (ref:mpisppy/cylinders/xhatxbar_bounder.py:37), with the rescue."""
    return evaluate(batch, round_integers(batch, xbar_nodes), opts)


def fixed_stack(batch: ScenarioBatch, cands: Tensor) -> boxqp.BoxQP:
    """One (k·S)-scenario BoxQP whose block j (scenarios j·S to
    (j+1)·S - 1) is the batch with its nonants fixed at cands[j]
    ((k, N) root candidates).  Shared fields (a shared dense A among
    them) stay shared; per-scenario ones are repeated along k."""
    k = cands.shape[0]
    fixed = [batch.with_fixed_nonants(c) for c in cands]
    qp = fixed[0]

    def rep(a):       # c/q/bl/bu: (S, k) batched or (k,) shared
        return a.repeat(k, 1) if a.ndim == 2 else a

    A = qp.A.repeat(k, 1, 1) if qp.A.ndim == 3 else qp.A
    return dataclasses.replace(
        qp, c=rep(qp.c), q=rep(qp.q), bl=rep(qp.bl), bu=rep(qp.bu), A=A,
        l=torch.cat([f.l for f in fixed]), u=torch.cat([f.u for f in fixed]))


def xhat_shuffle(batch: ScenarioBatch, x_non: Tensor, scen_ids, k: int,
                 opts: pdhg.PDHGOptions = pdhg.PDHGOptions(),
                 feas_tol: float = 1e-3):
    """Try k candidate scenarios' own nonant vectors as x̂, all at once.

    x_non: (S, N) current per-scenario nonants; scen_ids: (k,) candidate
    indices (the caller supplies the deterministic shuffle, seed 42,
    ref:mpisppy/cylinders/xhatshufflelooper_bounder.py:61-99).  The k
    cold evaluations run as ONE solve of the (k·S)-scenario fixed_stack
    batch, each block starting from its batch's own norm estimate, so
    every block follows its own evaluation's iterates.  Returns
    (values (k,), feasible (k,), cands (k, N), comps (k,)): cands is the
    (rounded) candidate tensor evaluated, comps each value's expected
    compensation for the comp_tight gate."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    ids = torch.as_tensor(scen_ids, device=x_non.device)
    cands = round_integers(batch, x_non[ids])  # (k, N)
    S = batch.num_scenarios
    qp = fixed_stack(batch, cands)
    opts = dataclasses.replace(opts, detect_infeas=True)
    # the norm depends on A alone: every block shares its batch's
    L = torch.broadcast_to(pdhg.estimate_norm(batch.qp, opts.power_iters),
                           (S,)).repeat(k)
    st = pdhg.solve(qp, opts, pdhg.init_state(qp, opts, Lnorm=L))
    obj, comp, _, scen_ok = (t.reshape(k, S)
                             for t in _per_scenario(qp, st, feas_tol))
    real = batch.p > 0.0
    feas = torch.all(torch.where(real, scen_ok, True), dim=-1)
    values = torch.where(feas, torch.sum(batch.p * obj, dim=-1),
                         torch.full_like(feas, float("inf"),
                                         dtype=obj.dtype))
    return values, feas, cands, torch.sum(batch.p * comp, dim=-1)


def slam_candidate(batch: ScenarioBatch, x_non: Tensor,
                   sense_max: bool) -> Tensor:
    """(N,) candidate from slamming each nonant to its across-scenario
    max (ceil for integers) or min (floor), over real scenarios."""
    mask = (batch.p > 0.0)[:, None]
    if sense_max:
        xhat = torch.where(mask, x_non, float("-inf")).amax(dim=0)
        return torch.where(batch.integer_slot, torch.ceil(xhat), xhat)
    xhat = torch.where(mask, x_non, float("inf")).amin(dim=0)
    return torch.where(batch.integer_slot, torch.floor(xhat), xhat)


def slam_heuristic(batch: ScenarioBatch, x_non: Tensor, sense_max: bool,
                   opts: pdhg.PDHGOptions = pdhg.PDHGOptions()
                   ) -> XhatResult:
    """Slam every nonant to its across-scenario max (or min) and evaluate
    (ref:mpisppy/cylinders/slam_heuristic.py:25-129), with the rescue."""
    return evaluate(batch, slam_candidate(batch, x_non, sense_max), opts)


class XhatEval:
    """Host-side evaluator with the reference Xhat_Eval surface
    (ref:mpisppy/utils/xhat_eval.py:33): evaluate(nonant_cache),
    evaluate_one, calculate_incumbent."""

    def __init__(self, batch: ScenarioBatch,
                 opts: pdhg.PDHGOptions = pdhg.PDHGOptions()):
        self.batch = batch
        self.opts = opts

    def evaluate_one(self, xhat) -> float:
        xhat = torch.as_tensor(np.asarray(xhat, np.float32),
                               device=self.batch.device)
        return float(evaluate(self.batch, xhat, self.opts).value)

    def evaluate(self, xhat) -> float:
        return self.evaluate_one(xhat)

    def calculate_incumbent(self, candidates) -> tuple[float, int]:
        """Best (value, index) over a list of candidates
        (ref:mpisppy/utils/xhat_eval.py:368)."""
        vals = [self.evaluate_one(x) for x in candidates]
        best = int(min(range(len(vals)), key=lambda i: vals[i]))
        return vals[best], best
