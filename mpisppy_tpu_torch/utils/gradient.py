###############################################################################
# Gradient-based cost and rho (port of mpisppy_tpu/utils/gradient.py;
# ref:mpisppy/utils/gradient.py:34-267, ref:mpisppy/utils/find_rho.py:
# 38-357).
#
# Find_Grad: fix the nonants at x̂, solve every scenario, and read the
# objective gradient c + q x at the solve (the objectives are explicit
# quadratics: no automatic differentiation).  Stored NEGATED ("gradient
# cost", ref:gradient.py:85-90).  The fixed-nonant solve is one batched
# pdhg.solve: on a dense shared A it runs in the window kernel.
#
# Find_Rho: the WW-heuristic rho from first-order conditions
# (ref:find_rho.py:152-225):  rho[s,i] = |cost[s,i] - W[s,i]| / denom,
# with denom per-scenario |x - xbar| (clipped to its max / tolerance,
# ref:find_rho.py:73-95) or the scenario-independent
# E[max(|x - xbar|, 1)] (ref:find_rho.py:117-150), aggregated across
# scenarios with the grad_order_stat triangular interpolation (0 = min,
# 0.5 = p-mean, 1 = max).  The gradient costs are computed in the
# batch's dtype on its device, as the JAX package does; everything after
# them runs in float64 numpy on the host.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch.core.batch import ScenarioBatch, concretize
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.utils.rho_utils import rhos_from_csv

E1_TOLERANCE = 1e-5  # ref:spbase E1_tolerance default


def _grad_costs(batch: ScenarioBatch, solver_x: torch.Tensor) -> np.ndarray:
    """(S, N) float64 negated objective gradients at the nonant columns,
    in ORIGINAL space (ref:gradient.py:55-90 compute_grad): one read of
    the device result (the whole axis's rows on a sharded batch)."""
    qp = batch.qp
    grad = qp.c + qp.q * solver_x
    g = -(grad[..., batch.nonant_idx] / batch.d_non)
    return batch.scen_host(g).astype(np.float64)


def find_grad_cost(batch: ScenarioBatch, xhat,
                   opts: pdhg.PDHGOptions | None = None) -> np.ndarray:
    """Batched analog of Find_Grad.find_grad_cost
    (ref:gradient.py:95-130): fix nonants at x̂, solve, grab gradients."""
    opts = opts or pdhg.PDHGOptions(tol=1e-6, max_iters=100_000)
    batch = concretize(batch)
    qp = batch.with_fixed_nonants(torch.as_tensor(
        np.asarray(xhat), dtype=batch.qp.c.dtype, device=batch.device))
    st = pdhg.solve(qp, opts, pdhg.init_state(qp, opts))
    return _grad_costs(dataclasses.replace(batch, qp=qp), st.x)


def w_denom(x_non: np.ndarray, xbar: np.ndarray) -> np.ndarray:
    """(S, N) per-scenario denominator |x - xbar|, zeros replaced by the
    row max (ref:find_rho.py:73-95)."""
    d = np.abs(np.asarray(x_non) - np.asarray(xbar))
    dmax = np.maximum(d.max(axis=-1, keepdims=True), E1_TOLERANCE)
    return np.where(d <= E1_TOLERANCE, dmax, d)


def prox_denom(x_non: np.ndarray, xbar: np.ndarray) -> np.ndarray:
    """2 (x - xbar)^2, floored like w_denom (ref:find_rho.py:97-115)."""
    d = np.asarray(x_non) - np.asarray(xbar)
    d = 2.0 * d * d
    dmax = np.maximum(d.max(axis=-1, keepdims=True), E1_TOLERANCE)
    return np.where(d <= E1_TOLERANCE, dmax, d)


def grad_denom(batch: ScenarioBatch, x_non: np.ndarray,
               xbar: np.ndarray,
               grad_rho_relative_bound: float = 1e3) -> np.ndarray:
    """(N,) scenario-independent denominator E[max(|x - xbar|, 1)]
    (ref:find_rho.py:117-150)."""
    p = batch.scen_host(batch.p).astype(np.float64)
    d = np.maximum(np.abs(np.asarray(x_non) - np.asarray(xbar)), 1.0)
    g = (p[:, None] * d).sum(0)
    return np.maximum(g, 1.0 / grad_rho_relative_bound)


def order_stat_aggregate(rho_scen: np.ndarray, p: np.ndarray,
                         alpha: float) -> np.ndarray:
    """Aggregate per-scenario rhos to one per slot with the triangular
    order statistic (ref:find_rho.py:186-224)."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(
            f"grad_order_stat must be in [0,1] (0=min, 0.5=mean, "
            f"1=max); got {alpha}")
    rmin = rho_scen.min(axis=0)
    rmax = rho_scen.max(axis=0)
    rmean = (p[:, None] * rho_scen).sum(0) / max(p.sum(), 1e-30)
    if alpha == 0.5:
        return rmean
    if alpha == 0.0:
        return rmin
    if alpha == 1.0:
        return rmax
    if alpha < 0.5:
        return rmin + alpha * 2.0 * (rmean - rmin)
    return (2.0 * rmean - rmax) + alpha * 2.0 * (rmax - rmean)


class Find_Rho:
    """ref:mpisppy/utils/find_rho.py:38.  Needs a PH object with a
    state (after Iter0 at least) and per-(scenario, slot) gradient costs
    (from find_grad_cost, or the PH object's own iterates)."""

    def __init__(self, ph, cfg=None):
        self.ph = ph
        self.cfg = cfg or {}
        self.c: np.ndarray | None = None  # (S, N) gradient costs

    def _get(self, name, default):
        try:
            v = self.cfg.get(name, default)
        except AttributeError:
            v = getattr(self.cfg, name, default)
        return default if v is None else v

    def compute_rho(self, indep_denom: bool = False,
                    denom_kind: str = "w") -> np.ndarray:
        """(N,) rho from the WW heuristic (ref:find_rho.py:152-225).
        denom_kind: 'w' (|x - xbar|) or 'prox' (2(x - xbar)^2);
        indep_denom selects the scenario-independent grad denominator.
        Reads x, x̄, W and p to the host once each (p twice with
        indep_denom)."""
        ph = self.ph
        batch = concretize(ph.batch)
        st = ph.state
        # the whole axis's rows on a sharded batch (one all-gather)
        x_non, xbar, W, p = (a.astype(np.float64) for a in batch.scen_host(
            batch.nonants(st.solver.x), st.xbar, st.W, batch.p))
        if self.c is None:
            # costs at the current iterates (the xhat-file path of the
            # reference is find_grad_cost)
            self.c = _grad_costs(batch, st.solver.x)
        if indep_denom:
            denom = grad_denom(
                batch, x_non, xbar,
                self._get("grad_rho_relative_bound", 1e3))[None, :]
        elif denom_kind == "prox":
            denom = prox_denom(x_non, xbar)
        else:
            denom = w_denom(x_non, xbar)
        rho_scen = np.abs((self.c - W) / denom)
        return order_stat_aggregate(rho_scen, p,
                                    float(self._get("grad_order_stat",
                                                    0.5)))


class Set_Rho:
    """rho_setter plumbing from a saved rho file
    (ref:find_rho.py:246-288)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def rho_setter(self, batch) -> np.ndarray:
        fname = self.cfg.get("rho_file_in") \
            if hasattr(self.cfg, "get") else self.cfg["rho_file_in"]
        return rhos_from_csv(fname, batch.num_nonants)
