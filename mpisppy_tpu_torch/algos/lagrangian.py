###############################################################################
# Lagrangian outer bounds from the scenario batch (port of
# mpisppy_tpu/algos/lagrangian.py).
#
#     L(W) = E_s [ min_x  f_s(x) + W_s . x_non ]   with  E_node[W] = 0
#
# is one batched solve on a qp whose c has W added on nonant slots
# (ref:mpisppy/cylinders/lagrangian_bounder.py:11-51).  The bound is
# certified from the DUAL side: each subproblem's Fenchel dual value is
# its contribution, and scenarios whose dual residual has not cleared
# tolerance make the bound uncertified.  The subgradient loop and the
# nonant reduced costs of a Lagrangian solve live here too.
###############################################################################
from __future__ import annotations

import dataclasses

import torch

from mpisppy_tpu_torch.core.batch import ScenarioBatch
from mpisppy_tpu_torch.ops import boxqp, pdhg

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LagrangianResult:
    bound: Tensor         # () E_s[dual value]
    per_scenario: Tensor  # (S,) per-scenario dual values
    dual_resid: Tensor    # (S,) relative dual residuals at exit
    certified: Tensor     # () bool: all real scenarios cleared tolerance
    solver: pdhg.PDHGState


def _lagrangian_qp(batch: ScenarioBatch, W: Tensor) -> boxqp.BoxQP:
    """Scenario objectives + W·x_non, no prox
    (ref:mpisppy/cylinders/lagrangian_bounder.py:13-19)."""
    return batch.with_nonant_linear_quad(W, torch.zeros_like(W))


def lagrangian_bound(batch: ScenarioBatch, W: Tensor,
                     opts: pdhg.PDHGOptions = pdhg.PDHGOptions(),
                     solver: pdhg.PDHGState | None = None
                     ) -> LagrangianResult:
    """One Lagrangian bound evaluation L(W); a valid outer bound when
    the per-node probability-weighted mean of W is ~0 (PH invariant,
    ref:mpisppy/phbase.py:114-179)."""
    qp = _lagrangian_qp(batch, W)
    st = pdhg.init_state(qp, opts) if solver is None else solver
    st = pdhg.solve(qp, opts, st)
    dual = boxqp.dual_objective(qp, st.x, st.y)
    _, rd, _ = boxqp.kkt_residuals(qp, st.x, st.y)
    tol = max(opts.tol, 5.0 * torch.finfo(st.x.dtype).eps)
    certified = batch.all_real(rd <= 10.0 * tol)
    return LagrangianResult(bound=batch.expectation(dual), per_scenario=dual,
                            dual_resid=rd, certified=certified, solver=st)


@dataclasses.dataclass(frozen=True)
class SubgradientState:
    W: Tensor
    xbar: Tensor
    solver: pdhg.PDHGState
    bound: Tensor
    best_bound: Tensor  # max over CERTIFIED bounds only
    certified: Tensor   # () bool: last bound's dual residuals cleared tol


def subgradient_step(batch: ScenarioBatch, st: SubgradientState,
                     rho: Tensor, opts: pdhg.PDHGOptions,
                     n_windows: int = 8) -> SubgradientState:
    """One subgradient iteration: solve with the current W (no prox),
    record the bound, take the nonanticipativity subgradient
    W += rho (x - x̄) (ref:mpisppy/cylinders/subgradient_bounder.py:
    12-54).  A truncated solve can leave the dual iterate infeasible,
    where dual_objective OVERESTIMATES L(W): such bounds never enter
    best_bound (the same dual-residual gate as lagrangian_bound)."""
    qp = _lagrangian_qp(batch, st.W)
    solver = pdhg.solve_fixed(qp, n_windows, opts, st.solver)
    dual = boxqp.dual_objective(qp, solver.x, solver.y)
    _, rd, _ = boxqp.kkt_residuals(qp, solver.x, solver.y)
    tol = max(opts.tol, 5.0 * torch.finfo(solver.x.dtype).eps)
    certified = batch.all_real(rd <= 10.0 * tol)
    bound = batch.expectation(dual)
    x_non = batch.nonants(solver.x)
    xbar, _ = batch.node_average(x_non)
    W = st.W + rho * (x_non - xbar)
    best = torch.where(certified, torch.maximum(st.best_bound, bound),
                       st.best_bound)
    return SubgradientState(W=W, xbar=xbar, solver=solver, bound=bound,
                            best_bound=best, certified=certified)


def subgradient_init(batch: ScenarioBatch,
                     opts: pdhg.PDHGOptions = pdhg.PDHGOptions(),
                     W: Tensor | None = None) -> SubgradientState:
    S, N = batch.num_scenarios, batch.num_nonants
    dt, dev = batch.qp.c.dtype, batch.device
    if W is None:
        W = torch.zeros((S, N), dtype=dt, device=dev)
    qp = _lagrangian_qp(batch, W)
    ninf = torch.tensor(-float("inf"), dtype=dt, device=dev)
    return SubgradientState(
        W=W, xbar=torch.zeros((S, N), dtype=dt, device=dev),
        solver=pdhg.init_state(qp, opts), bound=ninf,
        best_bound=ninf.clone(),
        certified=torch.tensor(False, device=dev))


def nonant_reduced_costs(batch: ScenarioBatch, W: Tensor,
                         solver: pdhg.PDHGState) -> Tensor:
    """(S, N) ORIGINAL-space reduced costs of the nonant columns at a
    Lagrangian solve's (x, y) (ref:mpisppy/cylinders/
    reduced_costs_spoke.py:108-171): (c + q x + A'y)[nonant] / d_non."""
    qp = _lagrangian_qp(batch, W)
    rc = qp.c + qp.q * solver.x + qp.rmatvec(solver.y)
    return rc[..., batch.nonant_idx] / batch.d_non
