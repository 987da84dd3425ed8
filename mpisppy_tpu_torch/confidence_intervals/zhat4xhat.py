###############################################################################
# zhat4xhat: the objective-value distribution of a fixed candidate x̂
# over sampled trees (port of mpisppy_tpu/confidence_intervals/
# zhat4xhat.py; ref:mpisppy/confidence_intervals/zhat4xhat.py:22-207).
#
# Two-stage: each "tree" is a batch of sampled scenarios; z_hat_j =
# E_batch[f(x̂, xi)] by one batched fixed-nonant evaluation (a dense
# shared A reaches the window kernel).  Multistage: each tree is a
# SampleSubtree solved with the root pinned at x̂ (a feasible
# nonanticipative policy, sample_tree).
###############################################################################
from __future__ import annotations

import math

import numpy as np
import scipy.stats

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.confidence_intervals import ciutils
from mpisppy_tpu_torch.ops import pdhg


def evaluate_sample_trees(xhat_one, num_samples: int, cfg,
                          module, InitSeed: int = 0,
                          branching_factors=None,
                          opts: pdhg.PDHGOptions | None = None,
                          device=None):
    """(zhats array, next_seed) (ref:zhat4xhat.py:22-110), on `device`
    (default: the cfg's "device", else CUDA)."""
    opts = opts or ciutils.DEFAULT_OPTS
    dev = ciutils.ci_device(cfg, device)
    seed = InitSeed
    zhats = []
    if branching_factors is None:
        branching_factors = cfg.get("branching_factors")
    if branching_factors:  # multistage
        from mpisppy_tpu_torch.confidence_intervals.sample_tree import (
            SampleSubtree, _number_of_nodes,
        )
        for _ in range(num_samples):
            st = SampleSubtree(module, xhat_one, branching_factors,
                               seed, cfg, opts, device=dev)
            zhats.append(st.run())
            seed += _number_of_nodes(branching_factors)
    else:
        from mpisppy_tpu_torch.algos import xhat as xhat_mod
        from mpisppy_tpu_torch.core import batch as batch_mod
        batch_size = int(cfg["num_scens"])
        kw = module.kw_creator(cfg)
        xhat = ciutils.root_tensor(xhat_one, dev)
        for _ in range(num_samples):
            names = module.scenario_names_creator(batch_size, start=seed)
            specs = [module.scenario_creator(nm, **kw) for nm in names]
            b = batch_mod.from_specs(specs, device=dev)
            res = xhat_mod.evaluate(b, xhat, opts)
            zhats.append(float(res.value))
            seed += batch_size
    return np.array(zhats), seed


def run_samples(cfg, module, xhat_one=None, num_samples: int = 10,
                confidence_level: float = 0.95, device=None):
    """The zhat4xhat driver (ref:zhat4xhat.py:107-180): t-interval on
    E[f(x̂)] from the sampled zhats."""
    if xhat_one is None:
        xhat_one = ciutils.read_xhat(cfg["xhatpath"])
    zhats, seed = evaluate_sample_trees(xhat_one, num_samples, cfg,
                                        module, device=device)
    zhatbar = float(np.mean(zhats))
    s_zhat = float(np.std(zhats, ddof=1)) if len(zhats) > 1 else 0.0
    t = scipy.stats.t.ppf(0.5 + confidence_level / 2.0,
                          max(len(zhats) - 1, 1))
    eps_z = t * s_zhat / math.sqrt(max(len(zhats), 1))
    global_toc(f"zhatbar = {zhatbar:.6g} +/- {eps_z:.6g} "
               f"({confidence_level:.0%} CI)", True)
    return zhatbar, eps_z
