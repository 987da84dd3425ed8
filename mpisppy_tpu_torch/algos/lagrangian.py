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
# tolerance make the bound uncertified.
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
    real = batch.p > 0.0
    certified = torch.all(torch.where(real, rd <= 10.0 * tol, True))
    return LagrangianResult(bound=batch.expectation(dual), per_scenario=dual,
                            dual_resid=rd, certified=certified, solver=st)
