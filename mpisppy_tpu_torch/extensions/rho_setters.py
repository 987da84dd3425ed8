###############################################################################
# Rho adaptation family (port of mpisppy_tpu/extensions/rho_setters.py;
# ref:mpisppy/extensions/norm_rho_updater.py:39, sep_rho.py:17,
# coeff_rho.py:15, mult_rho_updater.py:32, sensi_rho.py:15,
# reduced_costs_rho.py:15, gradient_extension.py:18).
#
# Each one replaces the (N,) rho vector the PH state carries, by
# dataclasses.replace between steps (_set_rho).  Every consumer reads rho
# from the state at its next step: the PH prox, the fused wheel's hub
# step and planes, the async wheel's stale plane; a checkpoint carries
# it as a PHState leaf.  The extensions' own counters are not
# checkpointed, as in the JAX package.  Each hook reads the device state
# it needs to the host once (a .cpu() per tensor), and only on the
# iterations where it acts.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch.core.batch import concretize
from mpisppy_tpu_torch.extensions.extension import Extension


def _set_rho(ph, rho_new) -> None:
    rho = torch.as_tensor(np.asarray(rho_new), dtype=ph.batch.qp.c.dtype,
                          device=ph.batch.device)
    ph.rho = rho
    if ph.state is not None:
        ph.state = dataclasses.replace(ph.state, rho=rho)


def _orig_cost_per_slot(batch) -> np.ndarray:
    """|c_i| of each nonant slot in ORIGINAL space, averaged over
    scenarios (the scaled c absorbs d_col: c_orig = c_scaled / d_col;
    the whole axis's rows on a sharded batch)."""
    c, d_col = batch.scen_host(batch.qp.c, torch.broadcast_to(
        batch.d_col, batch.qp.c.shape))
    idx = batch.nonant_idx.cpu().numpy()
    c_non = (c / d_col)[..., idx]
    if c_non.ndim == 2:
        c_non = np.abs(c_non).mean(axis=0)
    return np.abs(c_non)


class NormRhoUpdater(Extension):
    """Residual balancing (ref:mpisppy/extensions/norm_rho_updater.py:39):
    grow rho when the primal nonanticipativity residual dominates the
    dual movement, shrink when the dual dominates (ADMM mu/tau rule)."""

    def __init__(self, ph, mu: float = 10.0, tau: float = 2.0):
        super().__init__(ph)
        self.mu = mu
        self.tau = tau
        self._prev_xbar = None

    def enditer(self):
        ph = self.opt
        st = ph.state
        batch = concretize(ph.batch)
        x_non = batch.nonants(st.solver.x)
        primal = float(batch.expectation(
            (x_non - st.xbar).abs().sum(dim=-1)))
        xbar_nodes = st.xbar_nodes.cpu().numpy()
        if self._prev_xbar is not None:
            rho = st.rho.cpu().numpy()
            dual = float(np.sum(np.abs(
                rho.mean() * (xbar_nodes - self._prev_xbar))))
            if dual > 0:
                if primal > self.mu * dual:
                    _set_rho(ph, rho * self.tau)
                elif dual > self.mu * primal:
                    _set_rho(ph, rho / self.tau)
        self._prev_xbar = xbar_nodes


class SepRho(Extension):
    """Watson-Woodruff per-variable rho (ref:mpisppy/extensions/
    sep_rho.py:17): rho_i = multiplier * |c_i| / (max_s x_i - min_s x_i
    + 1), from the iter0 solutions."""

    def __init__(self, ph, multiplier: float = 1.0):
        super().__init__(ph)
        self.multiplier = float(
            getattr(ph.options, "sep_rho_multiplier", multiplier))

    def post_iter0(self):
        ph = self.opt
        batch = concretize(ph.batch)
        x_non, real = batch.scen_host(batch.nonants(ph.state.solver.x),
                                      batch.p > 0.0)
        xr = x_non[real]
        spread = xr.max(axis=0) - xr.min(axis=0)
        cost = _orig_cost_per_slot(batch)
        rho = self.multiplier * cost / (spread + 1.0)
        # zero-cost nonants (pure state variables) would get rho = 0 and
        # never reach consensus: floor them at a tenth of the mean
        # positive rho
        pos = rho[rho > 0.0]
        if pos.size:
            rho = np.maximum(rho, 0.1 * float(pos.mean()))
        else:
            rho = np.full_like(rho, self.multiplier)
        _set_rho(ph, rho)


class CoeffRho(Extension):
    """rho_i = multiplier * |c_i|
    (ref:mpisppy/extensions/coeff_rho.py:15)."""

    def __init__(self, ph, multiplier: float = 0.1):
        super().__init__(ph)
        self.multiplier = float(
            getattr(ph.options, "coeff_rho_multiplier", multiplier))

    def post_iter0(self):
        cost = _orig_cost_per_slot(concretize(self.opt.batch))
        _set_rho(self.opt, self.multiplier * np.maximum(cost, 1e-6))


class MultRhoUpdater(Extension):
    """Multiplicative rho schedule
    (ref:mpisppy/extensions/mult_rho_updater.py:32): every
    `mult_rho_update_interval` iterations from `first_iter` on, rho *=
    `mult_rho_update_factor` (stopping after `last_iter`; None never
    stops, the reference default)."""

    def __init__(self, ph, mult_rho_update_factor: float = 2.0,
                 mult_rho_update_interval: int = 2,
                 first_iter: int = 2, last_iter: int | None = None):
        super().__init__(ph)
        self.factor = mult_rho_update_factor
        self.interval = mult_rho_update_interval
        self.first_iter = first_iter
        self.last_iter = last_iter

    def miditer(self):
        ph = self.opt
        it = ph._iter
        if (self.first_iter <= it
                and (self.last_iter is None or it <= self.last_iter)
                and (it - self.first_iter) % self.interval == 0):
            _set_rho(ph, ph.state.rho.cpu().numpy() * self.factor)


class SensiRho(Extension):
    """KKT-sensitivity rho (ref:mpisppy/extensions/sensi_rho.py:15,75):
    per-slot rho from the order-stat aggregation of per-scenario
    |nonant sensitivities| at the iter0 solves, times
    `sensi_rho_multiplier`."""

    def __init__(self, ph, sensi_rho_multiplier: float = 1.0,
                 order_stat: float = 0.5):
        super().__init__(ph)
        self.multiplier = sensi_rho_multiplier
        self.order_stat = order_stat

    def post_iter0(self):
        from mpisppy_tpu_torch.utils.gradient import order_stat_aggregate
        from mpisppy_tpu_torch.utils.nonant_sensitivities import (
            nonant_sensitivities,
        )
        ph = self.opt
        sens = np.abs(nonant_sensitivities(ph.batch, ph.state.solver))
        p = ph.batch.scen_host(ph.batch.p).astype(np.float64)
        rho = order_stat_aggregate(sens, p, self.order_stat)
        rho = np.maximum(rho, 1e-6) * self.multiplier
        _set_rho(ph, rho)


class ReducedCostsRho(Extension):
    """rho from the expected |reduced costs| of the iter0 solve
    (ref:mpisppy/extensions/reduced_costs_rho.py:15): SensiRho's
    machinery (both read the solve's reduced costs) under the
    reference's own option name and multiplier."""

    def __init__(self, ph, rc_rho_multiplier: float = 1.0):
        super().__init__(ph)
        self._inner = SensiRho(ph, sensi_rho_multiplier=rc_rho_multiplier)

    def post_iter0(self):
        self._inner.post_iter0()


class Gradient_extension(Extension):
    """Dynamic gradient-based rho
    (ref:mpisppy/extensions/gradient_extension.py:18, base
    ref:dyn_rho_base.py:22): recompute the WW-heuristic rho every
    `grad_rho_update_interval` iterations from iteration 2 on, from the
    current iterates (Find_Rho with fresh gradient costs).  Between
    updates it reads nothing from the device."""

    def __init__(self, ph, grad_order_stat: float = 0.5,
                 grad_rho_update_interval: int = 5,
                 indep_denom: bool = False,
                 grad_rho_relative_bound: float = 1e3):
        super().__init__(ph)
        from mpisppy_tpu_torch.utils.gradient import Find_Rho
        self.interval = grad_rho_update_interval
        self.indep_denom = indep_denom
        self._finder = Find_Rho(ph, {
            "grad_order_stat": grad_order_stat,
            "grad_rho_relative_bound": grad_rho_relative_bound})

    def miditer(self):
        ph = self.opt
        if ph._iter < 2 or (ph._iter - 2) % self.interval != 0:
            return
        self._finder.c = None  # refresh gradient costs at the iterates
        rho = self._finder.compute_rho(indep_denom=self.indep_denom)
        _set_rho(ph, np.maximum(rho, 1e-6))
