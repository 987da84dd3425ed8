###############################################################################
# X-hat evaluation (port of the parts of mpisppy_tpu/algos/xhat.py the
# fused wheel uses).
#
# Fixing a candidate first stage into every scenario and solving for the
# recourse gives E[f(xhat, xi_s)], an inner (upper, for min) bound
# (ref:mpisppy/utils/xhat_eval.py:33-400).  A candidate evaluation is
# one batched solve of the same scenario tensors with the nonant box
# collapsed to the candidate point.
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


def _result(batch: ScenarioBatch, qp: boxqp.BoxQP, st: pdhg.PDHGState,
            feas_tol: float) -> XhatResult:
    """Compensated recourse values and the all-scenario feasibility
    gate at a solver state (UNBOUNDED is excluded too: a frozen
    unbounded iterate has an arbitrary finite objective)."""
    obj = torch.sum(qp.c * st.x + 0.5 * qp.q * st.x * st.x, dim=-1)
    comp = COMP_SAFETY * torch.sum(
        st.y.abs() * boxqp.primal_residual(qp, st.x), dim=-1)
    obj = obj + comp
    rp, _, _ = boxqp.kkt_residuals(qp, st.x, st.y)
    real = batch.p > 0.0
    scen_ok = (rp <= feas_tol) & (st.status != pdhg.INFEASIBLE) \
        & (st.status != pdhg.UNBOUNDED)
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
    batch = concretize(batch)  # scengen: draw the scenario data here
    qp = batch.with_fixed_nonants(xhat)
    wopts = dataclasses.replace(opts, detect_infeas=True)
    st = dataclasses.replace(solver, x=torch.clamp(solver.x, qp.l, qp.u))
    st = pdhg.solve(qp, wopts, st)
    res = _result(batch, qp, st, feas_tol)
    return _rescue_merge(batch, xhat, res, opts, feas_tol), st


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
