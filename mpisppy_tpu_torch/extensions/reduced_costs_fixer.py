###############################################################################
# ReducedCostsFixer: hub-side heuristic fixing and bound tightening from
# the ReducedCostsSpoke's expected reduced costs (port of
# mpisppy_tpu/extensions/reduced_costs_fixer.py;
# ref:mpisppy/extensions/reduced_costs_fixer.py:16-323).
#
# Mechanics (minimization):
#   * fixing (ref:reduced_costs_fixer.py:222-310): the
#     (1 - fix_fraction_target) quantile of nonzero |rc| is the cutoff;
#     slots with |rc| >= cutoff and x̄ at the matching bound get their box
#     collapsed to it (rc > 0 -> lb, rc < 0 -> ub); slots whose rc went
#     NaN or fell below the cutoff are UNFIXED (rc fixing is reversible).
#   * bound tightening (ref:reduced_costs_fixer.py:123-220): with a finite
#     gap (ib - ob), a slot at lb with rc > 0 satisfies x <= lb + gap/rc
#     in every optimal solution (floor for integers); symmetrically for
#     ub.  Applied to the batch's boxes, monotone.
###############################################################################
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.extensions.extension import Extension


class ReducedCostsFixer(Extension):
    def __init__(self, ph, fix_fraction_target_iter0: float = 0.0,
                 fix_fraction_target_iterK: float = 0.0,
                 zero_rc_tol: float = 1e-4, bound_tol: float = 1e-6,
                 use_rc_bt: bool = False, use_rc_fixer: bool = True,
                 rc_fixer_require_improving_lagrangian: bool = True,
                 verbose: bool = False):
        super().__init__(ph)
        if ph.batch.tree.num_nodes != 1:
            raise RuntimeError("ReducedCostsFixer supports two-stage "
                               "problems only (xbar/consensus are "
                               "root-node reductions)")
        for f in (fix_fraction_target_iter0, fix_fraction_target_iterK):
            if not 0.0 <= f <= 1.0:
                raise ValueError("fix fraction targets must be in [0,1]")
        self._f_iter0 = fix_fraction_target_iter0
        self._f_iterK = fix_fraction_target_iterK
        self.fix_fraction_target = fix_fraction_target_iter0
        self.zero_rc_tol = zero_rc_tol
        self.bound_tol = bound_tol
        self.use_rc_bt = use_rc_bt
        self.use_rc_fixer = use_rc_fixer
        self.require_improving = rc_fixer_require_improving_lagrangian
        self.verbose = verbose
        self._lb0, self._ub0 = ph.batch.nonant_box()
        self._lb = self._lb0.copy()   # current (possibly tightened)
        self._ub = self._ub0.copy()
        N = ph.batch.num_nonants
        self.fixed_mask = np.zeros(N, bool)
        self._fix_val = np.zeros(N)
        self._best_ob = -math.inf
        self.n_tightened = 0

    def nfixed(self) -> int:
        return int(self.fixed_mask.sum())

    def post_iter0(self):
        self.fix_fraction_target = self._f_iterK

    def _spoke(self):
        from mpisppy_tpu_torch.cylinders.spoke import ReducedCostsSpoke
        spcomm = self.opt.spcomm
        if spcomm is None:
            return None
        for sp in getattr(spcomm, "spokes", []):
            if isinstance(sp, ReducedCostsSpoke):
                return sp
        return None

    def _apply_boxes(self):
        """Install the current (lb, ub, fixed) into the batch (scaled)."""
        batch = self.opt.batch
        qp = batch.qp
        idx = batch.nonant_idx
        S, n = qp.c.shape
        lb = np.where(self.fixed_mask, self._fix_val, self._lb)
        ub = np.where(self.fixed_mask, self._fix_val, self._ub)
        d = torch.broadcast_to(batch.d_non, (S, len(idx)))
        l_full = torch.broadcast_to(qp.l, (S, n)).clone()
        u_full = torch.broadcast_to(qp.u, (S, n)).clone()
        l_full[:, idx] = torch.as_tensor(lb, dtype=l_full.dtype,
                                         device=l_full.device) / d
        u_full[:, idx] = torch.as_tensor(ub, dtype=u_full.dtype,
                                         device=u_full.device) / d
        self.opt.batch = dataclasses.replace(
            batch, qp=dataclasses.replace(qp, l=l_full, u=u_full))

    def sync_with_spokes(self):
        """The hub's exchange point: consume fresh reduced costs as soon
        as the hub harvests them (idempotent with the miditer pull)."""
        self.miditer()

    def miditer(self):
        sp = self._spoke()
        if sp is None or not sp.new_rc or sp.rc_global is None:
            return
        sp.new_rc = False
        rc = sp.rc_global
        spcomm = self.opt.spcomm
        ob = spcomm.BestOuterBound if spcomm is not None else -math.inf
        improving = ob > self._best_ob
        self._best_ob = max(self._best_ob, ob)
        changed = False
        if self.use_rc_bt:
            changed |= self._bounds_tightening(
                rc, getattr(sp, "last_lagrangian_bound", None))
        if self.use_rc_fixer and self.fix_fraction_target > 0.0:
            if improving or not self.require_improving:
                changed |= self._fixing(rc)
        if changed:
            self._apply_boxes()

    def _bounds_tightening(self, rc: np.ndarray,
                           lagrangian_bound: float | None) -> bool:
        spcomm = self.opt.spcomm
        if spcomm is None or lagrangian_bound is None:
            return False
        ib = spcomm.BestInnerBound
        # the gap against the bound of the SAME dual solution the rcs
        # came from (not the best outer bound, which another spoke may
        # have raised: that would understate the gap)
        ob = lagrangian_bound
        if not (math.isfinite(ib) and math.isfinite(ob)):
            return False
        gap = max(ib - ob, 0.0)
        is_int = self.opt.batch.integer_slot.cpu().numpy()
        ok = np.isfinite(rc)
        pos = ok & (rc > self.zero_rc_tol)
        neg = ok & (rc < -self.zero_rc_tol)
        new_ub = np.where(pos, self._lb + gap / np.where(pos, rc, 1.0),
                          np.inf)
        new_lb = np.where(neg, self._ub + gap / np.where(neg, rc, 1.0),
                          -np.inf)
        new_ub = np.where(is_int, np.floor(new_ub + 1e-9), new_ub)
        new_lb = np.where(is_int, np.ceil(new_lb - 1e-9), new_lb)
        tighter_u = new_ub < self._ub - 1e-12
        tighter_l = new_lb > self._lb + 1e-12
        self._ub = np.where(tighter_u, new_ub, self._ub)
        self._lb = np.where(tighter_l, new_lb, self._lb)
        cnt = int(tighter_u.sum() + tighter_l.sum())
        self.n_tightened += cnt
        if cnt and self.verbose:
            global_toc(f"rc bound tightening: {cnt} bounds", True)
        return cnt > 0

    def _fixing(self, rc: np.ndarray) -> bool:
        if np.all(np.isnan(rc)):
            return False
        abs_rc = np.abs(rc)
        nonzero = abs_rc[abs_rc > self.zero_rc_tol]
        if len(nonzero) == 0:
            target = self.zero_rc_tol
        else:
            target = np.nanquantile(nonzero,
                                    1.0 - self.fix_fraction_target,
                                    method="median_unbiased")
        target = max(target, self.zero_rc_tol)
        st = self.opt.state
        xbar = st.xbar_nodes[0].cpu().numpy() if st is not None else None
        changed = False
        for i in range(len(rc)):
            if np.isnan(abs_rc[i]) or abs_rc[i] < target:
                if self.fixed_mask[i]:      # unfix (reversible)
                    self.fixed_mask[i] = False
                    changed = True
                continue
            if self.fixed_mask[i]:
                continue
            near_lb = xbar is None or \
                xbar[i] - self._lb[i] <= max(self.bound_tol, 1e-4)
            near_ub = xbar is None or \
                self._ub[i] - xbar[i] <= max(self.bound_tol, 1e-4)
            if rc[i] > self.zero_rc_tol and near_lb:
                self._fix_val[i] = self._lb[i]
            elif rc[i] < -self.zero_rc_tol and near_ub:
                self._fix_val[i] = self._ub[i]
            else:
                continue
            self.fixed_mask[i] = True
            changed = True
        if changed and self.verbose:
            global_toc(f"rc fixer: {self.nfixed()} fixed", True)
        return changed
