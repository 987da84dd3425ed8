###############################################################################
# PrimalDualConverger (port of mpisppy_tpu/convergers/
# primal_dual_converger.py; ref:mpisppy/convergers/
# primal_dual_converger.py:17,66-120): stop when BOTH
#   primal: sum_s p_s ||x_s - xbar||_1          (nonanticipativity gap)
#   dual:   ||rho * (xbar_t - xbar_{t-1})||_1   (dual movement)
# fall below `tol`.  The primal metric is a reduction on the state's
# device; x̄ and rho come to the host once per call, where the dual
# metric is taken against the x̄ of the call before.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.convergers.converger import Converger


class PrimalDualConverger(Converger):
    """ref:mpisppy/convergers/primal_dual_converger.py:17."""

    def __init__(self, opt, tol: float = 1e-2):
        super().__init__(opt)
        self.tol = float(tol)
        self._prev_xbar = None
        self.trace: list[tuple[float, float]] = []

    def is_converged(self) -> bool:
        batch = self.opt.batch
        st = self.opt.state
        x_non = batch.nonants(st.solver.x)
        primal = float(batch.expectation((x_non - st.xbar).abs().sum(dim=-1)))
        xbar_nodes = st.xbar_nodes.cpu().numpy()
        if self._prev_xbar is None:
            dual = np.inf
        else:
            rho = st.rho.cpu().numpy()
            dual = float(np.sum(np.abs(rho * (xbar_nodes
                                              - self._prev_xbar))))
        self._prev_xbar = xbar_nodes
        self.conv_value = max(primal, dual)
        self.trace.append((primal, dual))
        return primal < self.tol and dual < self.tol
