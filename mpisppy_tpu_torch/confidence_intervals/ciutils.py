###############################################################################
# CI utilities (port of mpisppy_tpu/confidence_intervals/ciutils.py;
# ref:mpisppy/confidence_intervals/ciutils.py:141-445).
#
# gap_estimators is the statistical core: sample n scenarios, solve the
# induced approximate problem (the sampled EF) for (z_n*, x*), evaluate
# the candidate x̂ AND x* on every sampled scenario, and form the
# Mak-Morton-Wood gap estimator
#   G = E_n[f(x̂, xi) - f(x*, xi)],  s^2 = (E[g^2] - G^2)/(1 - ||p||^2)
# (ref:ciutils.py:404-427).  Both evaluations are one batched
# fixed-nonant solve each over the sampled batch (algos/xhat.py: a dense
# shared A reaches the window kernel), and the EF (algos/ef.py) is
# solved as a batch of one problem, so a dense EF reaches it too where
# a window design takes its shape.  Every entry point runs on `device`
# (default: the cfg's "device", else CUDA; without CUDA it raises).
###############################################################################
from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch

from mpisppy_tpu_torch import global_toc, resolve_device
from mpisppy_tpu_torch.ops import boxqp, pdhg, pdhg_window
from mpisppy_tpu_torch.telemetry import console

#: the CI drivers' solve options when the caller passes none, and the
#: only ones MMWConfidenceIntervals, SeqSampling and the mmw_conf CLI
#: use: the JAX package's tol 1e-7 lies under the f32 floor, so every
#: solve would run its whole 200,000-iteration cap (ROADMAP C1)
DEFAULT_OPTS = pdhg.PDHGOptions(tol=1e-6, max_iters=20_000)


def ci_device(cfg, device=None) -> torch.device:
    """The device a CI entry point runs on: `device`, else the cfg's
    "device" (the CLI's --device), else CUDA."""
    if device is None and cfg is not None:
        device = cfg.get("device")
    return resolve_device(device)


def write_xhat(xhat, path: str = "xhat.npy"):
    """ref:ciutils.py:156-161 — flat npy of the root xhat."""
    np.save(path, np.asarray(xhat, np.float64))


def read_xhat(path: str = "xhat.npy", delete_file: bool = False):
    """ref:ciutils.py:163-173."""
    xhat = np.load(path)
    if delete_file:
        os.remove(path)
    return xhat


def branching_factors_from_numscens(numscens: int,
                                    num_stages: int) -> list[int]:
    """Even branching factors whose product is >= numscens
    (ref:ciutils.py:126-139)."""
    if num_stages == 2:
        return [numscens]
    stages = num_stages - 1
    b = max(2, int(math.ceil(numscens ** (1.0 / stages))))
    return [b] * stages


def scalable_branching_factors(numscens: int, ref_bfs) -> list[int]:
    """Scale the model's branching factors so the product is close to
    (>=) numscens while keeping the shape (ref:ciutils.py:104-124)."""
    ref_bfs = list(ref_bfs)
    prod = int(np.prod(ref_bfs))
    if prod >= numscens:
        return ref_bfs
    fac = (numscens / prod) ** (1.0 / len(ref_bfs))
    return [max(b, int(math.ceil(b * fac))) for b in ref_bfs]


def correcting_numeric(G: float, objfct: float,
                       relative_error: bool = True,
                       threshold: float = 1e-4) -> float:
    """Clip small negative G from numerical error (ref:ciutils.py:191-211,
    minimization)."""
    crit = threshold * abs(objfct) if relative_error else threshold
    if G <= -crit:
        global_toc(f"WARNING: gap estimator has the wrong sign: {G}", True)
        return G
    return max(0.0, G)


def _sample_specs(module, scenario_names, cfg):
    """The host ScenarioSpecs of `scenario_names` from the module's
    creator with the cfg's model kwargs."""
    kw = module.kw_creator(cfg)
    return [module.scenario_creator(nm, **kw) for nm in scenario_names]


def root_tensor(xhat, device) -> torch.Tensor:
    """A root x̂ as the f32 tensor an evaluation fixes the nonants at."""
    return torch.as_tensor(np.asarray(xhat, np.float32), device=device)


def gap_estimators(xhat_one, module, scenario_names, cfg,
                   ArRP: int = 1, opts: pdhg.PDHGOptions | None = None,
                   verbose: bool = False, device=None) -> dict:
    """G and s at x̂ from one sampled batch (ref:ciutils.py:214-433;
    two-stage: the multistage path is gap_estimators_mstage).

    Returns {"G", "s", "seed", "zn_star", "xstar"} (plus
    "seed_provenance" when the sample came from a scengen program); the
    pooled ArRP>1 path returns only {"G", "s", "seed"}, as the
    reference (ref:ciutils.py:291-319)."""
    from mpisppy_tpu_torch.algos import xhat as xhat_mod
    from mpisppy_tpu_torch.algos.ef import build_ef
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.scengen.program import program_from_cfg
    from mpisppy_tpu_torch.utils.sputils import extract_num

    opts = opts or DEFAULT_OPTS
    dev = ci_device(cfg, device)
    start = extract_num(scenario_names[0])

    if ArRP > 1:
        # pooled estimators (ref:ciutils.py:291-319); the recursive
        # ArRP=1 call pins each pool's probabilities itself
        n = len(scenario_names)
        if n % ArRP != 0:
            raise ValueError(
                f"{n} scenarios is not a multiple of ArRP={ArRP}; "
                "silently dropping the tail would desynchronize "
                "seed accounting (the reference raises too)")
        Gs, ss = [], []
        for k in range(ArRP):
            part = scenario_names[k * (n // ArRP):(k + 1) * (n // ArRP)]
            est = gap_estimators(xhat_one, module, part, cfg, ArRP=1,
                                 opts=opts, device=dev)
            Gs.append(est["G"])
            ss.append(est["s"])
        return {"G": float(np.mean(Gs)),
                "s": float(np.linalg.norm(ss) / np.sqrt(n // ArRP)),
                "seed": start + n}

    # the sample IS the distribution: uniform probabilities over the
    # sampled scenarios (ref:ciutils.py:344-349), on a copy of the cfg
    cfg = copy.deepcopy(cfg)
    cfg.quick_assign("num_scens", int, len(scenario_names))
    prog = program_from_cfg(module, cfg, len(scenario_names), start=start)
    if prog is not None:
        specs = prog.to_specs()
    else:
        specs = _sample_specs(module, scenario_names, cfg)
    b = batch_mod.from_specs(specs, device=dev)

    # the sampled EF for (zn_star, x*), as a batch of one problem where a
    # window design takes its shape (a dense EF then runs in the window
    # kernel, on an H100 the split design: one problem over the card),
    # else unbatched (the plain iteration: a dense EF past every
    # design's shared memory); the route is logged, audibly when it is
    # the plain one
    efp = build_ef(specs, device=dev)
    qp = boxqp.one_problem(efp.qp)
    if pdhg_window.takes(qp, opts.iter_precision):
        route, level = "as one problem on the window route", console.DEBUG
    else:
        qp = efp.qp
        route, level = ("unbatched on the plain iteration: no window "
                        "design takes its shape"), console.INFO
    console.log(f"gap_estimators: the sampled EF ({efp.qp.m} x "
                f"{efp.qp.n}) on {dev.type} {route}", level=level)
    st = pdhg.solve(qp, opts, pdhg.init_state(qp, opts))
    n0 = specs[0].c.shape[0]
    nonant_idx = np.asarray(specs[0].nonant_idx)
    d0 = np.asarray(efp.scaling.d_col)[:n0]
    xstar = (st.x.reshape(-1).detach().cpu().numpy()[:n0] * d0)[nonant_idx]

    # x̂ and x* on every sampled scenario (batched)
    ev_xhat = xhat_mod.evaluate(b, root_tensor(xhat_one, dev), opts)
    ev_xstar = xhat_mod.evaluate(b, root_tensor(xstar, dev), opts)
    # an infeasible candidate has NO defined gap: per_scenario would
    # hold the arbitrary objective of a frozen iterate
    if not bool(ev_xhat.feasible):
        raise RuntimeError(
            "gap_estimators: xhat is infeasible for some sampled "
            "scenario (recourse evaluation failed); the gap is "
            "undefined for this candidate")
    if not bool(ev_xstar.feasible):
        raise RuntimeError(
            "gap_estimators: the sampled-EF solution failed its own "
            "recourse evaluation (solver tolerance issue)")
    f_hat = ev_xhat.per_scenario.detach().cpu().numpy().astype(np.float64)
    f_star = ev_xstar.per_scenario.detach().cpu().numpy().astype(np.float64)
    p = b.p.detach().cpu().numpy().astype(np.float64)

    gaps = f_hat - f_star
    G = float(np.dot(gaps, p))
    ssq = float(np.dot(gaps * gaps, p))
    prob_sqnorm = float(np.dot(p, p))
    sample_var = max((ssq - G * G) / max(1.0 - prob_sqnorm, 1e-12), 0.0)
    s = math.sqrt(sample_var)

    obj_at_xhat = float(np.dot(f_hat, p))
    G = correcting_numeric(G, objfct=obj_at_xhat,
                           relative_error=abs(obj_at_xhat) > 1)
    if verbose:
        global_toc(f"gap estimator: G={G:.6g} s={s:.6g}", True)
    out = {"G": G, "s": s, "seed": start + len(scenario_names),
           "zn_star": float(np.dot(f_star, p)), "xstar": xstar}
    if prog is not None:
        out["seed_provenance"] = prog.provenance()
    return out


def gap_estimators_mstage(xhat_one, module, n_trees: int, cfg,
                          start_seed: int, branching_factors,
                          opts: pdhg.PDHGOptions | None = None,
                          device=None) -> dict:
    """Multistage gap estimators over independently sampled scenario
    TREES (ref:mpisppy/confidence_intervals/multi_seqsampling.py:31-340
    and ciutils gap_estimators' EF_mstage branch): each i.i.d. sample i
    is a seeded subtree; z*_i is its free EF optimum, z_xhat_i the EF
    with the root pinned at x̂ (sample_tree.SampleSubtree).  Both use the
    SAME seed: common random numbers, the reference's variance-reduction
    choice.

    Returns {"G", "s", "seed"} with seed advanced by the node-id count
    of every sampled tree."""
    from mpisppy_tpu_torch.confidence_intervals.sample_tree import (
        SampleSubtree, _number_of_nodes,
    )

    dev = ci_device(cfg, device)
    gaps = []
    zhats = []
    seed = start_seed
    for _ in range(n_trees):
        zstar = SampleSubtree(module, None, branching_factors, seed, cfg,
                              opts, device=dev).run()
        zxhat = SampleSubtree(module, xhat_one, branching_factors, seed,
                              cfg, opts, device=dev).run()
        gaps.append(zxhat - zstar)
        zhats.append(zxhat)
        seed += _number_of_nodes(branching_factors)
    gaps = np.asarray(gaps, np.float64)
    G = float(np.mean(gaps))
    s = float(np.std(gaps, ddof=1)) if len(gaps) > 1 else 0.0
    obj = float(np.mean(zhats))
    G = correcting_numeric(G, objfct=obj, relative_error=abs(obj) > 1)
    return {"G": G, "s": s, "seed": seed}
