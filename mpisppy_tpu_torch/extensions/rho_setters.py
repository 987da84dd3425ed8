###############################################################################
# Per-variable rho (port of SepRho from mpisppy_tpu/extensions/
# rho_setters.py; ref:mpisppy/extensions/sep_rho.py:17).
#
# The extension mutates the (N,) rho vector the PH state carries, by
# dataclasses.replace between steps.  The other rho setters of the JAX
# module (NormRhoUpdater, CoeffRho, ...) are not ported (ROADMAP queue A,
# item 8).
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
    scenarios (the scaled c absorbs d_col: c_orig = c_scaled / d_col)."""
    c = batch.qp.c.cpu().numpy()
    d_col = batch.d_col.cpu().numpy()
    idx = batch.nonant_idx.cpu().numpy()
    c_non = (c / d_col)[..., idx]
    if c_non.ndim == 2:
        c_non = np.abs(c_non).mean(axis=0)
    return np.abs(c_non)


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
        x_non = batch.nonants(ph.state.solver.x).cpu().numpy()
        real = (batch.p > 0.0).cpu().numpy()
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
