###############################################################################
# Mak-Morton-Wood confidence intervals (port of
# mpisppy_tpu/confidence_intervals/mmw_ci.py;
# ref:mpisppy/confidence_intervals/mmw_ci.py:34-192).
#
# Batches of the gap estimator G around a fixed candidate x̂:
#   Gbar = mean(G_i),  eps_g = t_{alpha, B-1} std(G)/sqrt(B)
#   gap CI = [0, Gbar + eps_g]
###############################################################################
from __future__ import annotations

import numpy as np
import scipy.stats

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.confidence_intervals import ciutils


class MMWConfidenceIntervals:
    """ref:mmw_ci.py:34.  `module` is a model module with the standard
    5-function API; `xhat_one` the candidate root solution.  Every
    sampled EF and evaluation is solved at ciutils.DEFAULT_OPTS on
    `device` (default: the cfg's "device", else CUDA)."""

    def __init__(self, module, cfg, xhat_one, num_batches: int,
                 batch_size: int | None = None, start: int | None = None,
                 verbose: bool = True, device=None):
        self.module = module
        self.cfg = cfg
        self.xhat_one = np.asarray(xhat_one, np.float64)
        self.num_batches = num_batches
        self.batch_size = batch_size or int(cfg["num_scens"])
        if start is None:
            raise RuntimeError("Start must be specified "
                               "(ref:mmw_ci.py:77-80)")
        self.start = start
        self.verbose = verbose
        self.device = ciutils.ci_device(cfg, device)

    def run(self, confidence_level: float = 0.95) -> dict:
        """ref:mmw_ci.py:130-190."""
        start = self.start
        G = np.zeros(self.num_batches)
        provenance = []
        # gap_estimators pins num_scens to the sample size itself
        for i in range(self.num_batches):
            names = self.module.scenario_names_creator(self.batch_size,
                                                       start=start)
            est = ciutils.gap_estimators(self.xhat_one, self.module,
                                         names, self.cfg, device=self.device)
            start = est["seed"]
            G[i] = est["G"]
            if "seed_provenance" in est:
                provenance.append(est["seed_provenance"])
            if self.verbose:
                global_toc(f"Gn={G[i]:.6g} for batch {i}", True)

        s_g = float(np.std(G))
        Gbar = float(np.mean(G))
        t_g = scipy.stats.t.ppf(confidence_level, self.num_batches - 1)
        epsilon_g = t_g * s_g / np.sqrt(self.num_batches)
        self.result = {
            "gap_inner_bound": Gbar + epsilon_g,
            "gap_outer_bound": 0.0,
            "Gbar": Gbar,
            "std": s_g,
            "Glist": G.tolist(),
        }
        if provenance:
            # scengen replication batches: the exact key windows every
            # G_i was drawn from, so the CI is reproducible from this
            # record alone
            self.result["seed_provenance"] = provenance
        return self.result
