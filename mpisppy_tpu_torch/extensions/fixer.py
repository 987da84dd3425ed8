###############################################################################
# Fixer: WW-style fixing of (near-)converged nonants (port of
# mpisppy_tpu/extensions/fixer.py; ref:mpisppy/extensions/fixer.py:
# 27-335).
#
# The per-slot statistic is the cross-scenario spread |x_s,i - xbar_i|,
# reduced on the device and read once per iteration; a slot that stays
# converged for `lag` consecutive iterations is fixed by collapsing its
# box in the batch's qp to its node average (rounded for integer slots),
# after which every batched solve treats it as a constant.  The PH object's
# batch is replaced, as extensions/reduced_costs_fixer.py does; the PH
# and fused-wheel steps read `ph.batch` at each step, so every plane sees
# the fixed boxes.  Fixing is monotone (never unfixed), the reference
# default.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch.core.batch import mesh_reduce
from mpisppy_tpu_torch.extensions.extension import Extension


class Fixer(Extension):
    """Options read from ph.options when present: fixer_lag (default 5),
    fixer_tol (1e-4), fixer_integer_only (True)."""

    def __init__(self, ph):
        super().__init__(ph)
        opt = ph.options
        self.lag = int(getattr(opt, "fixer_lag", 5))
        self.tol = float(getattr(opt, "fixer_tol", 1e-4))
        self.integer_only = bool(getattr(opt, "fixer_integer_only", True))
        N = ph.batch.num_nonants
        self._streak = np.zeros(N, np.int64)
        self.fixed_mask = np.zeros(N, bool)

    def nfixed(self) -> int:
        return int(self.fixed_mask.sum())

    def enditer(self):
        ph = self.opt
        batch = ph.batch
        st = ph.state
        x_non = batch.nonants(st.solver.x)
        real = (batch.p > 0.0)[:, None]
        spread = mesh_reduce(batch, torch.where(
            real, (x_non - st.xbar).abs(), 0.0).amax(dim=0),
            "max").cpu().numpy()
        conv = spread <= self.tol
        self._streak = np.where(conv, self._streak + 1, 0)

        eligible = ~self.fixed_mask & (self._streak >= self.lag)
        integer_slot = batch.integer_slot.cpu().numpy()
        if self.integer_only:
            eligible &= integer_slot
        if not eligible.any():
            return

        idx = np.nonzero(eligible)[0]
        # each scenario's slot is pinned to ITS owning tree node's
        # average (for two-stage every row reads the root's)
        node_of_slot = batch.node_of_slot.cpu().numpy()        # (S, N)
        xbar_nodes = st.xbar_nodes.cpu().numpy()               # (nodes, N)
        vals = xbar_nodes[node_of_slot[:, idx], idx]           # (S, k)
        vals = np.where(integer_slot[idx], np.round(vals), vals)

        # collapse the box at the fixed slots (scaled space, per scenario)
        qp = batch.qp
        d_non = batch.d_non.cpu().numpy()
        d = d_non[idx] if d_non.ndim == 1 else d_non[:, idx]
        cols = torch.as_tensor(batch.nonant_idx.cpu().numpy()[idx],
                               device=batch.device)
        xs = torch.as_tensor(vals / d, dtype=qp.l.dtype, device=batch.device)
        S, n = qp.c.shape
        l_full = torch.broadcast_to(qp.l, (S, n)).clone()
        u_full = torch.broadcast_to(qp.u, (S, n)).clone()
        l_full[:, cols] = xs
        u_full[:, cols] = xs
        ph.batch = dataclasses.replace(batch, qp=dataclasses.replace(
            qp, l=l_full, u=u_full))
        self.fixed_mask[idx] = True
