###############################################################################
# NormRhoConverger (port of mpisppy_tpu/convergers/norm_rho_converger.py;
# ref:mpisppy/convergers/norm_rho_converger.py:18): stop when the
# rho-weighted primal metric  sum_s p_s || rho * (x_s - xbar) ||_1  falls
# below a threshold, the quantity NormRhoUpdater adapts on.
###############################################################################
from __future__ import annotations

from mpisppy_tpu_torch.convergers.converger import Converger


class NormRhoConverger(Converger):
    """ref:mpisppy/convergers/norm_rho_converger.py:18."""

    def __init__(self, opt):
        super().__init__(opt)
        self.tol = float(getattr(opt, "norm_rho_tol", 1e-4))

    def is_converged(self) -> bool:
        batch = self.opt.batch
        st = self.opt.state
        x_non = batch.nonants(st.solver.x)
        metric = batch.expectation(
            (st.rho * (x_non - st.xbar)).abs().sum(dim=-1))
        self.conv_value = float(metric)
        return self.conv_value < self.tol
