###############################################################################
# FractionalConverger: the fraction of integer nonants not yet converged
# across scenarios (port of mpisppy_tpu/convergers/fracintsnotconv.py;
# ref:mpisppy/convergers/fracintsnotconv.py:19).  An integer slot has
# converged when every scenario agrees with the rounded node average to
# within `ratio_tol`.
###############################################################################
from __future__ import annotations

import torch

from mpisppy_tpu_torch.convergers.converger import Converger


class FractionalConverger(Converger):
    """ref:mpisppy/convergers/fracintsnotconv.py:19."""

    def __init__(self, opt):
        super().__init__(opt)
        options = getattr(opt, "options", None)
        odict = getattr(options, "__dict__", {}) if options else {}
        self.fracthresh = float(
            getattr(opt, "frac_thresh", odict.get("frac_thresh", 0.05)))
        self.ratio_tol = 1e-4

    def is_converged(self) -> bool:
        batch = self.opt.batch
        mask = batch.integer_slot.cpu().numpy()
        if not mask.any():
            self.conv_value = 0.0
            return True
        st = self.opt.state
        x_non = batch.nonants(st.solver.x)
        real = (batch.p > 0.0)[:, None]
        dev = torch.where(real, (x_non - torch.round(st.xbar)).abs(), 0.0)
        slot_conv = dev.amax(dim=0) <= self.ratio_tol   # (N,)
        notconv = ~slot_conv.cpu().numpy() & mask
        self.conv_value = float(notconv.sum() / mask.sum())
        return self.conv_value < self.fracthresh
