###############################################################################
# Per-nonant sensitivities (port of mpisppy_tpu/utils/
# nonant_sensitivities.py; ref:mpisppy/utils/nonant_sensitivities.py,
# backed there by an interior-point KKT interface).
#
# The batched PDHG solve already gives that object: the ORIGINAL-space
# reduced cost  rc = (c + q x + A'y) / d_col  at an (approximately)
# optimal primal-dual pair is the objective's sensitivity to moving the
# nonant off its value (zero for strictly interior basic variables).
###############################################################################
from __future__ import annotations

import numpy as np
import torch

from mpisppy_tpu_torch.algos.lagrangian import nonant_reduced_costs
from mpisppy_tpu_torch.core.batch import ScenarioBatch, concretize
from mpisppy_tpu_torch.ops import pdhg


def nonant_sensitivities(batch: ScenarioBatch,
                         solver: pdhg.PDHGState) -> np.ndarray:
    """(S, N) float64 objective sensitivities of the nonants at a solve:
    the W=0 reduced costs (algos.lagrangian.nonant_reduced_costs), read
    to the host once."""
    batch = concretize(batch)
    W0 = torch.zeros((batch.num_scenarios, batch.num_nonants),
                     dtype=batch.qp.c.dtype, device=batch.device)
    rc = nonant_reduced_costs(batch, W0, solver)
    return batch.scen_host(rc).astype(np.float64)
