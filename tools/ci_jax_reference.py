#!/usr/bin/env python
"""The JAX package's confidence-interval numbers that chip_smoke.py's
[ci_mmw] and [ci_mstage] phases hold the port to, computed on the CPU.

    JAX_PLATFORMS=cpu python tools/ci_jax_reference.py

Prints, with chip_smoke.py's sizes, seeds and PDHG options (the
constants below; chip_smoke.py keeps the same numbers):
  * the MMW candidate: the root solution of the sampled extensive form
    of synthetic sslp 15x45 (LP relaxation) over Scenario0..MMW_BATCH-1,
    solved at MMW_TOL;
  * MMWConfidenceIntervals at that candidate: MMW_BATCHES batches of
    MMW_BATCH scenarios from scenario MMW_BATCH on, every sampled EF and
    evaluation at MMW_TOL with an MMW_CAP-iteration cap: Glist, Gbar,
    std, gap_inner_bound, and |E f(x̂)| of the first batch (the scale of
    the phase's tolerance);
  * aircond (3, 3, 2) through its scengen program (use_scengen) at the
    root x̂ MSTAGE_XHAT: gap_estimators_mstage over MSTAGE_TREES trees
    from seed MSTAGE_SEED, and evaluate_sample_trees' zhats over as many
    trees from the same seed, every EF at MSTAGE_TOL.
Imports only the JAX package; the port is not involved.
"""
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from mpisppy_tpu.algos.ef import ExtensiveForm  # noqa: E402
from mpisppy_tpu.confidence_intervals import ciutils  # noqa: E402
from mpisppy_tpu.confidence_intervals import mmw_ci, zhat4xhat  # noqa: E402
from mpisppy_tpu.models import aircond, sslp  # noqa: E402
from mpisppy_tpu.ops import pdhg  # noqa: E402
from mpisppy_tpu.utils.config import Config  # noqa: E402

# [ci_mmw] (chip_smoke.py keeps the same numbers); the tol and cap are
# the port's CI default (mpisppy_tpu_torch/confidence_intervals/ciutils.py
# DEFAULT_OPTS), with which its MMWConfidenceIntervals always solves
MMW_BATCH = 9
MMW_BATCHES = 3
MMW_TOL, MMW_CAP = 1e-6, 20_000
# [ci_mstage]
MSTAGE_BFS = (3, 3, 2)
MSTAGE_XHAT = (200.0, 0.0)
MSTAGE_TREES = 3
MSTAGE_SEED = 101
MSTAGE_TOL, MSTAGE_CAP = 1e-6, 20_000


def sslp_cfg(num_scens):
    cfg = Config()
    for k, v in (("num_scens", num_scens), ("n_servers", 15),
                 ("n_clients", 45), ("sslp_lp_relax", True)):
        cfg.quick_assign(k, type(v), v)
    return cfg


def mmw_candidate():
    cfg = sslp_cfg(MMW_BATCH)
    names = sslp.scenario_names_creator(MMW_BATCH)
    ef = ExtensiveForm({"tol": MMW_TOL, "max_iters": MMW_CAP}, names,
                       sslp.scenario_creator, sslp.kw_creator(cfg))
    ef.solve_extensive_form()
    sol = ef.get_root_solution()
    return np.array([sol[f"x{i}"] for i in range(15)])


def mmw(xhat):
    opts = pdhg.PDHGOptions(tol=MMW_TOL, max_iters=MMW_CAP)
    real = ciutils.gap_estimators
    scale = []

    def with_opts(*a, **kw):
        est = real(*a, opts=opts, **kw)
        scale.append(abs(est["zn_star"] + est["G"]))
        return est
    # MMWConfidenceIntervals takes no options: its gap estimators get
    # the port's default through the module attribute it calls
    ciutils.gap_estimators = with_opts
    try:
        res = mmw_ci.MMWConfidenceIntervals(
            sslp, sslp_cfg(MMW_BATCH), xhat, num_batches=MMW_BATCHES,
            batch_size=MMW_BATCH, start=MMW_BATCH, verbose=False).run()
    finally:
        ciutils.gap_estimators = real
    return res, scale[0]


def mstage():
    cfg = Config()
    cfg.quick_assign("use_scengen", bool, True)
    cfg.quick_assign("branching_factors", list, list(MSTAGE_BFS))
    opts = pdhg.PDHGOptions(tol=MSTAGE_TOL, max_iters=MSTAGE_CAP)
    xhat = np.array(MSTAGE_XHAT)
    est = ciutils.gap_estimators_mstage(xhat, aircond, MSTAGE_TREES, cfg,
                                        MSTAGE_SEED, list(MSTAGE_BFS),
                                        opts=opts)
    zhats, seed = zhat4xhat.evaluate_sample_trees(
        xhat, MSTAGE_TREES, cfg, aircond, InitSeed=MSTAGE_SEED,
        branching_factors=MSTAGE_BFS, opts=opts)
    return est, zhats, seed


def main():
    t0 = time.perf_counter()
    xhat = mmw_candidate()
    print("MMW_XHAT =", json.dumps([float(v) for v in xhat]))
    res, scale = mmw(xhat)
    print("MMW_JAX =", json.dumps({k: res[k] for k in (
        "Glist", "Gbar", "std", "gap_inner_bound")}))
    print("MMW_SCALE =", repr(scale))
    est, zhats, seed = mstage()
    print("MSTAGE_JAX =", json.dumps({
        "G": est["G"], "s": est["s"], "seed": est["seed"],
        "zhats": [float(z) for z in zhats], "zhat_seed": int(seed)}))
    print(f"# {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
