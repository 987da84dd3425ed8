###############################################################################
# Exact integer optimization over the scenario batch (port of
# mpisppy_tpu/algos/mip.py).
#
# The reference certifies integer solutions by handing every scenario
# subproblem to Gurobi/CPLEX (ref:mpisppy/spopt.py:99-247,884); here the
# batched branch-and-bound of ops/bnb.py does it:
#
#   * lagrangian_mip_bound — a certified OUTER bound for the true MIP:
#       L(W) = E_s[ min over the INTEGER feasible set of f_s + W.x_non ]
#     with E_node[W] = 0; the per-scenario B&B outer bounds keep
#     E[outer_s] <= L(W) <= z_MIP valid at any round budget.
#   * evaluate_mip — a certified INNER bound: fix an integral first
#     stage and solve every scenario's integer recourse exactly
#     (ref:mpisppy/utils/xhat_eval.py:254-340).
#   * ef_mip — branch-and-bound on the assembled extensive form (a batch
#     of one (S*n)-wide problem; ref:mpisppy/opt/ef.py:75-104's role).
#   * certified_mip_gap — the driver: LP-relaxed PH for (W, xbar),
#     candidate first stages, the two bounds above, then first-stage
#     branching (decomposition_bnb) while the gap stays open.
#
# Every solve_mip here goes through the dispatch scheduler
# (dispatch/scheduler.py): batch shapes pad up the bucket ladder and
# concurrent callers coalesce into megabatches.  Under a configured
# fault domain a quarantined solve raises dispatch.SolveFailed:
# decomposition_bnb absorbs per-node failures (the parent bound stays a
# certified stand-in); the one-shot oracles propagate it.
###############################################################################
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from mpisppy_tpu_torch import dispatch as _dispatch
from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.core.batch import ScenarioBatch, require_unsharded
from mpisppy_tpu_torch.ops import bnb
from mpisppy_tpu_torch.ops.bnb import BnBOptions

Tensor = torch.Tensor


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, Tensor) \
        else np.asarray(t)


def _aggregate_inner(per_scenario, feas_s, p):
    """(value, feasible, per-scenario values): the all-real-scenarios-
    feasible gate and the p-weighted expectation."""
    real = p > 0.0
    feas = bool(np.all(np.where(real, _host(feas_s), True)))
    inner_s = _host(per_scenario)
    value = float(np.sum(np.where(real, p * inner_s, 0.0))) if feas \
        else float("inf")
    return value, feas, inner_s


def _int_cols(batch: ScenarioBatch) -> np.ndarray:
    cols = np.nonzero(_host(batch.integer_full))[0]
    if cols.size == 0:
        raise ValueError("problem has no integer columns; use the LP path")
    return cols.astype(np.int64)


def _as_tensor(batch: ScenarioBatch, v) -> Tensor:
    """v (a tensor or array-like) on the batch's device and dtype."""
    if isinstance(v, Tensor):
        return v.to(dtype=batch.qp.c.dtype, device=batch.device)
    return torch.as_tensor(np.asarray(v, np.float32),
                           dtype=batch.qp.c.dtype, device=batch.device)


def _round_slots(batch: ScenarioBatch, xhat) -> Tensor:
    """xhat on the batch's device with its integer slots rounded."""
    xhat = _as_tensor(batch, xhat)
    return torch.where(batch.integer_slot, torch.round(xhat), xhat)


def lagrangian_mip_bound(batch: ScenarioBatch, W,
                         opts: BnBOptions = BnBOptions()) -> dict:
    """Certified MIP outer bound at multiplier W (valid when the
    per-node probability-weighted mean of W is 0, the PH invariant):
    each scenario's Lagrangian subproblem is solved AS A MIP
    (ref:mpisppy/cylinders/lagrangian_bounder.py:21-44)."""
    require_unsharded(batch, "mip.lagrangian_mip_bound")
    W = _as_tensor(batch, W)
    qp = batch.with_nonant_linear_quad(W, torch.zeros_like(W))
    res = _dispatch.solve_mip(qp, batch.d_col, _int_cols(batch), opts)
    p = _host(batch.p)
    outer_s = _host(res.outer)
    # padded scenarios (p=0) may carry -inf outers; mask before weighing
    bound = float(np.sum(np.where(p > 0.0, p * outer_s, 0.0)))
    return {
        "bound": bound,
        "per_scenario": outer_s,
        "solved": _host(res.gap) <= opts.gap_tol,
        "result": res,
    }


def _polish_swap(opts: BnBOptions) -> BnBOptions:
    """swap_rounds for a polish context: 0 (auto) promotes to
    bnb.POLISH_SWAP_ROUNDS; an explicit value is honored verbatim."""
    if opts.swap_rounds != 0:
        return opts
    return dataclasses.replace(opts, swap_rounds=bnb.POLISH_SWAP_ROUNDS)


def evaluate_mip(batch: ScenarioBatch, xhat,
                 opts: BnBOptions = BnBOptions()) -> dict:
    """Certified MIP inner bound: E[f(xhat)] with INTEGER recourse.

    xhat ((N,) root-only or (num_nodes, N)) is rounded on integer slots
    first; each scenario's recourse MIP is then solved by the batched
    B&B.  `value` is +inf unless every real scenario found an
    integer-feasible recourse.  A POLISH context: swap_rounds 0 (auto)
    promotes to bnb.POLISH_SWAP_ROUNDS."""
    require_unsharded(batch, "mip.evaluate_mip")
    opts = _polish_swap(opts)
    xhat = _round_slots(batch, xhat)
    qp = batch.with_fixed_nonants(xhat)
    res = _dispatch.solve_mip(qp, batch.d_col, _int_cols(batch), opts)
    p = _host(batch.p)
    real = p > 0.0
    value, feas, inner_s = _aggregate_inner(res.inner, res.feasible, p)
    # the recourse B&B's outer bounds bracket the true E[f(xhat)]
    lower = float(np.sum(np.where(real, p * _host(res.outer), 0.0)))
    return {
        "value": value,
        "value_lower": lower,
        "per_scenario": inner_s,
        "feasible": feas,
        "xhat": _host(xhat),
        "result": res,
    }


def evaluate_mip_polished(batch: ScenarioBatch, xhat,
                          opts: BnBOptions = BnBOptions(),
                          multistart: int = 24, lns_rounds: int = 60,
                          base: dict | None = None,
                          verbose: bool = False) -> dict:
    """evaluate_mip plus the heavy per-scenario incumbent polish for
    FINAL-candidate certification: jitter-diversified multistart dives
    (bnb.dive_multistart) merged with the B&B incumbents, then
    large-neighborhood repair (bnb.lns_repair).  `base`: a fresh
    evaluate_mip dict for the SAME xhat (skips the internal re-solve)."""
    require_unsharded(batch, "mip.evaluate_mip_polished")
    opts = _polish_swap(opts)
    if base is None:
        base = evaluate_mip(batch, xhat, opts)
    res = base["result"]
    inc, x_inc, feas_s = res.inner, res.x, res.feasible
    qp = batch.with_fixed_nonants(_as_tensor(batch, base["xhat"]))
    int_cols = _int_cols(batch)
    sos1 = bnb.detect_sos1_groups(qp, batch.d_col, int_cols)
    if multistart > 0:
        ms = bnb.dive_multistart(qp, batch.d_col, int_cols, opts,
                                 K=multistart, sos1=sos1)
        inc, x_inc, feas_s = bnb.merge_incumbents(inc, x_inc, feas_s, *ms)
        global_toc(f"[polish] multistart merge: {_host(inc)}", verbose)
    if lns_rounds > 0:
        rep = bnb.lns_repair(qp, batch.d_col, int_cols, x_inc, inc,
                             feas_s, opts, rounds=lns_rounds,
                             destroy_frac=0.35, sos1=sos1, verbose=verbose)
        if rep is not None:
            inc, x_inc, feas_s = bnb.merge_incumbents(inc, x_inc, feas_s,
                                                      *rep)
    value, feas, inner_s = _aggregate_inner(inc, feas_s, _host(batch.p))
    out = dict(base)
    out.update({"value": value, "per_scenario": inner_s, "feasible": feas,
                # the POLISHED per-scenario solutions
                "x": _host(x_inc)})
    return out


def _tile(x, K: int, batched_ndim: int):
    """x repeated K times along its batch axis (an EllMatrix tiles its
    values); shared fields broadcast across the K*S batch."""
    if hasattr(x, "vals"):
        return x.with_vals(_tile(x.vals, K, batched_ndim))
    if getattr(x, "ndim", 0) != batched_ndim:
        return x
    return x.repeat((K,) + (1,) * (batched_ndim - 1))


def evaluate_mip_many(batch: ScenarioBatch, xhats,
                      opts: BnBOptions = BnBOptions()) -> list[dict]:
    """Certified MIP inner bounds for K candidate first stages in ONE
    batched B&B of K*S subproblems (ref:mpisppy/cylinders/
    xhatshufflelooper_bounder.py:23-157 tries them sequentially).
    Returns one evaluate_mip-style dict per candidate.  A POLISH
    context (pass a negative swap_rounds for cheap screening)."""
    require_unsharded(batch, "mip.evaluate_mip_many")
    opts = _polish_swap(opts)
    K = len(xhats)
    if K == 0:
        return []
    S = batch.num_scenarios
    xr = [_round_slots(batch, xh) for xh in xhats]
    qps = [batch.with_fixed_nonants(xh) for xh in xr]
    qp0 = batch.qp
    qp = dataclasses.replace(
        qp0,
        c=_tile(qp0.c, K, 2), q=_tile(qp0.q, K, 2), A=_tile(qp0.A, K, 3),
        bl=_tile(qp0.bl, K, 2), bu=_tile(qp0.bu, K, 2),
        l=torch.cat([q.l for q in qps]), u=torch.cat([q.u for q in qps]))
    d_col = _tile(batch.d_col, K, 2)
    res = _dispatch.solve_mip(qp, d_col, _int_cols(batch), opts)
    p = _host(batch.p)
    real = p > 0.0
    feas_ks = _host(res.feasible).reshape(K, S)
    inner_ks = _host(res.inner).reshape(K, S)
    outer_ks = _host(res.outer).reshape(K, S)
    out = []
    for k in range(K):
        feas = bool(np.all(np.where(real, feas_ks[k], True)))
        value = float(np.sum(np.where(real, p * inner_ks[k], 0.0))) \
            if feas else float("inf")
        out.append({
            "value": value,
            "value_lower": float(np.sum(np.where(real, p * outer_ks[k],
                                                 0.0))),
            "per_scenario": inner_ks[k],
            "feasible": feas,
            "xhat": _host(xr[k]),
        })
    return out


def first_stage_local_search(batch: ScenarioBatch, xhat0, inner0: float,
                             opts: BnBOptions = BnBOptions(),
                             max_rounds: int = 8,
                             verbose: bool = False) -> dict:
    """1-flip local search over the INTEGER first-stage slots, each
    round one batched evaluate_mip_many over all neighbors."""
    int_slots = np.nonzero(_host(batch.integer_slot))[0]
    lb, ub = batch.nonant_box()
    best = np.asarray(_host(xhat0), float).copy()
    best_val = float(inner0)
    for rnd in range(max_rounds):
        cands = []
        for j in int_slots:
            for v in (best[j] - 1.0, best[j] + 1.0):
                if lb[j] - 1e-6 <= v <= ub[j] + 1e-6:
                    c = best.copy()
                    c[j] = v
                    cands.append(c)
        evs = evaluate_mip_many(batch, cands, opts)
        vals = [e["value"] if e["feasible"] else float("inf") for e in evs]
        k = int(np.argmin(vals)) if vals else 0
        if not vals or vals[k] >= best_val - 1e-9:
            break
        best_val = vals[k]
        best = np.asarray(cands[k], float)
        global_toc(f"[ls] round {rnd}: inner -> {best_val:.6g}", verbose)
    return {"xhat": best, "value": best_val}


def _subgradient(batch: ScenarioBatch, res):
    """(x_non, x_non - xbar) of the integer solutions (original space)."""
    x_non = res.x[:, batch.nonant_idx]
    xbar, _ = batch.node_average(x_non)
    return x_non, x_non - xbar


def mip_dual_ascent_polyak(batch: ScenarioBatch, W, inner: float,
                           steps: int, opts: BnBOptions = BnBOptions(),
                           lam0: float = 1.0, target: float | None = None,
                           verbose: bool = False) -> dict:
    """Level-target subgradient ascent on the INTEGER Lagrangian dual:

        level_t = best_t + level_frac * (inner - best_t)
        step_t  = lam * max(level_t - L(W_t), 0) / ||g_t||_p^2,
        g_t     = x_t - xbar_t  (p-weighted node-mean-zero),

    with lam halved after two non-improving steps.  Each step is one
    batched scenario-MIP solve; stops early at `target`.  Returns
    {'bound','W','history'}."""
    require_unsharded(batch, "mip.mip_dual_ascent_polyak")
    W = _as_tensor(batch, W)
    best, best_W = -float("inf"), W
    lam, since = float(lam0), 0
    level_frac = 0.3
    p = _host(batch.p)
    hist = []
    for t in range(steps):
        lag = lagrangian_mip_bound(batch, W, opts)
        L = lag["bound"]
        hist.append(L)
        global_toc(f"[polyak] step {t}: L = {L:.6g} (best "
                   f"{max(best, L):.6g}, lam {lam:.3g})", verbose)
        if L > best:
            best, best_W = L, W
            since = 0
        else:
            since += 1
            if since >= 2:
                lam *= 0.5
                since = 0
        if target is not None and best >= target:
            break
        res = lag["result"]
        if not bool(np.all(_host(res.feasible)[p > 0.0])):
            break  # no integer point to take a subgradient from
        _, g = _subgradient(batch, res)
        gnorm2 = float(torch.sum(batch.p[:, None] * g * g))
        if gnorm2 <= 1e-12 or not np.isfinite(inner):
            break
        base = best if np.isfinite(best) else L
        level = base + level_frac * max(inner - base, 0.0)
        step = lam * max(level - L, 0.0) / gnorm2
        if step <= 0.0:
            break
        W = W + step * g
    return {"bound": best, "W": best_W, "history": hist}


def mip_dual_bundle(batch: ScenarioBatch, W, inner: float,
                    steps: int, opts: BnBOptions = BnBOptions(),
                    target: float | None = None,
                    trust0: float = 2.0,
                    verbose: bool = False) -> dict:
    """Trust-region BUNDLE method on the INTEGER Lagrangian dual.  Every
    oracle call at W_k returns a CERTIFIED bound E_s[outer_s] (what gets
    reported) and a cut D(V) <= E_s[f_s(x_k,s) + V_s'x_non,k,s] from the
    per-scenario incumbents.  The master maximizes the cutting-plane
    model over the PH-invariant subspace inside an inf-norm trust region
    (a host LP, scipy/HiGHS): a direction-finder only, since ANY W it
    proposes yields a certified bound from the oracle.  Two-stage trees
    only.  Returns {'bound','W','history'}."""
    require_unsharded(batch, "mip.mip_dual_bundle")
    from scipy.optimize import linprog

    if batch.tree.num_stages != 2:
        raise ValueError("mip_dual_bundle: two-stage batches only")
    W = np.asarray(_host(W), np.float64)
    p = np.asarray(_host(batch.p), np.float64)
    real = p > 0.0
    S, N = W.shape
    nv = S * N
    cuts_a, cuts_b = [], []     # cut k: D(V) <= b_k + a_k . V
    best, best_W = -np.inf, W.copy()
    trust = float(trust0)
    hist = []
    center = W.copy()
    W_try = center
    nonant_idx = _host(batch.nonant_idx)
    for t in range(steps):
        Wk = center if t == 0 else W_try
        lag = lagrangian_mip_bound(batch, Wk + 0.0, opts)
        L = lag["bound"]
        hist.append(L)
        # plain > while best is still -inf (-inf + inf would be nan)
        serious = (L > best if not np.isfinite(best)
                   else L > best + 1e-9 * max(1.0, abs(best)))
        if serious:
            best, best_W = L, Wk.copy()
            center = Wk.copy()
            trust = min(trust * 1.6, 1e4)
        else:
            trust = max(trust * 0.5, 1e-5)
        global_toc(f"[bundle] step {t}: L={L:.6g} best={best:.6g} "
                   f"trust={trust:.3g}", verbose)
        if target is not None and best >= target:
            break
        res = lag["result"]
        if bool(np.all(_host(res.feasible)[real])):
            x_non = _host(res.x)[:, nonant_idx]
            # res.inner is the LAGRANGIAN objective f_s(x_k)+W_k.x_non:
            # the cut needs the raw f_s(x_k)
            wdot = np.sum(np.asarray(Wk) * x_non, axis=-1)
            fvals = _host(res.inner) - wdot
            cuts_a.append((p[:, None] * x_non).reshape(nv))
            cuts_b.append(float(np.sum(np.where(real, p * fvals, 0.0))))
        if not cuts_a:
            break
        # master LP: max t  s.t. t <= b_k + a_k.V, mean-zero, trust box
        nc = len(cuts_a)
        c_lp = np.zeros(nv + 1)
        c_lp[-1] = -1.0                      # maximize t
        A_ub = np.zeros((nc, nv + 1))
        b_ub = np.zeros(nc)
        for k in range(nc):
            A_ub[k, :nv] = -cuts_a[k]
            A_ub[k, -1] = 1.0
            b_ub[k] = cuts_b[k]
        A_eq = np.zeros((N, nv + 1))
        for j in range(N):
            for s in range(S):
                A_eq[j, s * N + j] = p[s]
        b_eq = np.zeros(N)
        lb = np.concatenate([(center - trust).reshape(nv), [-np.inf]])
        ub = np.concatenate([(center + trust).reshape(nv), [np.inf]])
        sol = linprog(c_lp, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                      bounds=np.stack([lb, ub], axis=1), method="highs")
        if not sol.success:
            global_toc(f"[bundle] master failed: {sol.message}", verbose)
            break
        W_try = sol.x[:nv].reshape(S, N)
        model_val = -sol.fun
        # model agrees with reality: the dual is (locally) maxed out
        if np.isfinite(best) \
                and model_val <= best + 1e-7 * max(1.0, abs(best)) \
                and trust <= 1e-4:
            break
    return {"bound": best, "W": best_W, "history": hist}


def ef_mip(ef_problem, specs, opts: BnBOptions = BnBOptions(),
           verbose: bool = False) -> dict:
    """Exact MIP solve of an assembled extensive form (algos/ef.py
    EFProblem) — the correctness oracle for the decomposition bounds.
    Returns inner/outer/gap and the (S, n) per-scenario solution in
    original space.  A POLISH context (swap_rounds 0 promotes)."""
    opts = _polish_swap(opts)
    qp = ef_problem.qp
    n_tot = qp.c.shape[-1]
    n = ef_problem.n_per_scen
    S = len(specs)
    integer = np.zeros(n_tot, bool)
    for s, sp in enumerate(specs):
        if sp.integer is not None:
            integer[s * n:(s + 1) * n] = np.asarray(sp.integer, bool)
    cols = np.nonzero(integer)[0].astype(np.int64)
    qp1 = dataclasses.replace(
        qp, c=qp.c[None], q=qp.q[None], bl=qp.bl[None], bu=qp.bu[None],
        l=qp.l[None], u=qp.u[None])   # batch of one; A broadcasts
    d_col = torch.as_tensor(np.asarray(ef_problem.scaling.d_col, np.float32),
                            device=qp.device)[None]
    res = _dispatch.solve_mip(qp1, d_col, cols, opts, verbose=verbose)
    return {
        "inner": float(res.inner[0]),
        "outer": float(res.outer[0]),
        "gap": float(res.gap[0]),
        "x": _host(res.x)[0].reshape(S, n),
        "nodes": int(res.nodes_solved[0]),
        "result": res,
    }


def mip_dual_ascent(batch: ScenarioBatch, W, rho, steps: int,
                    opts: BnBOptions = BnBOptions()) -> dict:
    """Subgradient ascent on the MIP Lagrangian dual: each step solves
    the scenario MIPs at W, records the certified bound, and updates
    W += rho (x - xbar) from the INTEGER solutions
    (ref:mpisppy/cylinders/subgradient_bounder.py:12-54).  Returns the
    best certified bound and the W that achieved it."""
    require_unsharded(batch, "mip.mip_dual_ascent")
    W = _as_tensor(batch, W)
    best, best_W = -float("inf"), W
    rho = _as_tensor(batch, rho)
    p = _host(batch.p)
    for _ in range(steps):
        lag = lagrangian_mip_bound(batch, W, opts)
        if lag["bound"] > best:
            best, best_W = lag["bound"], W
        res = lag["result"]
        if not bool(np.all(_host(res.feasible)[p > 0.0])):
            break  # no integer solution to take a subgradient from
        _, g = _subgradient(batch, res)
        W = W + rho * g
    lag = lagrangian_mip_bound(batch, W, opts)
    if lag["bound"] > best:
        best, best_W = lag["bound"], W
    return {"bound": best, "W": best_W}


def _restrict_first_stage(batch: ScenarioBatch, qp, int_slots: np.ndarray,
                          lo: np.ndarray, hi: np.ndarray):
    """qp with the integer NONANT slots' box intersected with the
    ORIGINAL-space node box [lo, hi] (first-stage branching)."""
    S = batch.num_scenarios
    n = qp.c.shape[-1]
    dt, dev = qp.c.dtype, qp.c.device
    l_full = torch.broadcast_to(qp.l, (S, n)).clone()
    u_full = torch.broadcast_to(qp.u, (S, n)).clone()
    cols = torch.as_tensor(_host(batch.nonant_idx)[int_slots], device=dev)
    slots = torch.as_tensor(int_slots, device=dev)
    d = torch.broadcast_to(batch.d_non, (S, batch.num_nonants))[:, slots]
    lo_t = torch.as_tensor(np.asarray(lo, np.float32), dtype=dt, device=dev)
    hi_t = torch.as_tensor(np.asarray(hi, np.float32), dtype=dt, device=dev)
    l_full[:, cols] = torch.maximum(l_full[:, cols], lo_t / d)
    u_full[:, cols] = torch.minimum(u_full[:, cols], hi_t / d)
    return dataclasses.replace(qp, l=l_full, u=u_full)


def decomposition_bnb(batch: ScenarioBatch, W,
                      opts: BnBOptions = BnBOptions(),
                      max_nodes: int = 30,
                      target_gap: float = 5e-3,
                      inner0: float = float("inf"),
                      xhat0=None,
                      node_fanout: int = 4,
                      verbose: bool = False) -> dict:
    """Branch-and-bound on the FIRST-STAGE integer nonants with
    scenario-decomposed bounds (the dual-decomposition B&B family):

      node = a box on the integer first-stage slots (original space)
      bound(node) = E_s[ B&B outer bound of min f_s + W.x_non
                         s.t. x_non in node box ]   (valid: E[W] = 0)
      incumbent(node) = evaluate_mip at the node solution's rounded
                        probability-weighted mean, clipped into the box

    Up to `node_fanout` best-first nodes pop per round and their
    (fanout * S)-lane bound solves ride ONE megabatch dispatch through
    the scheduler (only the search order changes; every bound stays
    certified).  Returns {'inner','outer','gap','xhat','nodes',
    'failed_nodes'}."""
    require_unsharded(batch, "mip.decomposition_bnb")
    int_slots = np.nonzero(_host(batch.integer_slot))[0]
    if int_slots.size == 0:
        raise ValueError("no integer first-stage slots to branch on")
    lb_all, ub_all = batch.nonant_box()
    lo0 = np.ceil(lb_all[int_slots] - 1e-6)
    hi0 = np.floor(ub_all[int_slots] + 1e-6)

    W = _as_tensor(batch, W)
    qp_W = batch.with_nonant_linear_quad(W, torch.zeros_like(W))
    int_cols = _int_cols(batch)
    p = _host(batch.p)
    real = p > 0.0
    nonant_idx = _host(batch.nonant_idx)

    inner = float(inner0)
    xhat_best = None if xhat0 is None else _host(xhat0)
    fathom_floor = float("inf")
    tried: set[tuple] = set()
    heap: list = []
    counter = 0
    heapq.heappush(heap, (-np.inf, counter, lo0, hi0))
    nodes = 0
    failed_nodes = 0

    def scale(v):
        return max(1.0, abs(v)) if np.isfinite(v) else 1.0

    sched = _dispatch.get_scheduler()
    fanout = max(1, int(node_fanout))
    while heap and nodes < max_nodes:
        # pop up to `fanout` surviving best-first nodes; the scheduler
        # coalesces their same-key submits into ONE megabatch
        popped = []
        while heap and len(popped) < fanout \
                and nodes + len(popped) < max_nodes:
            node_bound, _, lo, hi = heapq.heappop(heap)
            if np.isfinite(inner) \
                    and node_bound >= inner - target_gap * scale(inner):
                fathom_floor = min(fathom_floor, node_bound)
                continue
            popped.append((node_bound, lo, hi))
        if not popped:
            break
        # build every node qp BEFORE submitting, so the submits land in
        # one admission window
        qp_nodes = [_restrict_first_stage(batch, qp_W, int_slots, lo, hi)
                    for _, lo, hi in popped]
        tickets = [sched.submit(qpn, batch.d_col, int_cols, opts)
                   for qpn in qp_nodes]
        for (node_bound, lo, hi), ticket in zip(popped, tickets):
            try:
                res = ticket.result()
            except _dispatch.SolveFailed as e:
                # the PARENT bound still bounds everything under the
                # node: fold it into the fathom floor (never re-queue)
                nodes += 1
                failed_nodes += 1
                fathom_floor = min(fathom_floor, node_bound)
                global_toc(f"[ddbnb] node solve quarantined ({e.reason}):"
                           f" holding parent bound {node_bound:.6g}",
                           verbose)
                continue
            nodes += 1
            outer_s = _host(res.outer)
            nb = float(np.sum(np.where(real, p * outer_s, 0.0)))
            nb = max(nb, node_bound)  # parent bound still valid

            feas_s = _host(res.feasible)
            if bool(np.all(feas_s[real])):
                x_non = _host(res.x)[:, nonant_idx]
                xbar = (p[:, None] * x_non).sum(0)
                cand = xbar.copy()
                cand[int_slots] = np.clip(np.round(xbar[int_slots]), lo, hi)
                key = tuple(np.round(cand[int_slots]).astype(int))
                if key not in tried:
                    tried.add(key)
                    try:
                        ev = evaluate_mip(batch, cand.astype(np.float32),
                                          opts)
                    except _dispatch.SolveFailed as e:
                        # a quarantined candidate eval costs one
                        # candidate, never the run
                        global_toc(f"[ddbnb] incumbent eval quarantined "
                                   f"({e.reason}); skipping candidate",
                                   verbose)
                        ev = None
                    if ev is not None and ev["feasible"] \
                            and ev["value"] < inner:
                        inner, xhat_best = ev["value"], ev["xhat"]
                spread = (p[:, None] * np.abs(
                    x_non - xbar[None, :])).sum(0)[int_slots]
            else:
                # no integer solution in some scenario: branch on width
                spread = (hi - lo).astype(float)

            if np.isfinite(inner) \
                    and nb >= inner - target_gap * scale(inner):
                fathom_floor = min(fathom_floor, nb)
                global_toc(f"[ddbnb] node {nodes}: fathomed at {nb:.6g} "
                           f"(inner {inner:.6g})", verbose)
                continue
            branchable = hi > lo
            if not bool(np.any(branchable)):
                fathom_floor = min(fathom_floor, nb)  # leaf
                continue
            j = int(np.argmax(np.where(branchable, spread, -1.0)))
            if bool(np.all(feas_s[real])):
                split = float(np.clip(
                    np.floor((p[:, None] * x_non).sum(0)[int_slots][j]),
                    lo[j], hi[j] - 1))
            else:
                split = float(np.floor(0.5 * (lo[j] + hi[j])))
            lo_up = lo.copy()
            hi_dn = hi.copy()
            hi_dn[j] = split
            lo_up[j] = split + 1.0
            counter += 1
            heapq.heappush(heap, (nb, counter, lo, hi_dn))
            counter += 1
            heapq.heappush(heap, (nb, counter, lo_up, hi))
            global_toc(f"[ddbnb] node {nodes}: bound {nb:.6g} inner "
                       f"{inner:.6g} branch slot {int_slots[j]} at {split}",
                       verbose)

    open_min = min((b for b, *_ in heap), default=float("inf"))
    outer = min(open_min, fathom_floor, inner)
    gap = (inner - outer) / scale(inner) if np.isfinite(inner) \
        else float("inf")
    return {"inner": inner, "outer": outer, "gap": gap,
            "xhat": xhat_best, "nodes": nodes,
            "failed_nodes": failed_nodes}


@dataclasses.dataclass
class MIPGapResult:
    inner: float          # certified upper bound (integer-feasible)
    outer: float          # certified lower bound
    gap: float            # (inner - outer) / max(1, |inner|)
    xhat: np.ndarray      # the first stage achieving `inner`
    trivial_bound: float  # LP wait-and-see bound from PH iter0
    ph_conv: float


def _head(x, k: int, batched_ndim: int):
    """The first k scenarios of a batched field (an EllMatrix slices its
    values); shared fields pass through."""
    if hasattr(x, "vals"):
        return x.with_vals(_head(x.vals, k, batched_ndim))
    return x[:k] if getattr(x, "ndim", 0) == batched_ndim else x


def certified_mip_gap(batch: ScenarioBatch, ph_options=None,
                      opts: BnBOptions = BnBOptions(),
                      ascent_steps: int = 0,
                      n_shuffle: int = 2,
                      target_gap: float = 5e-3,
                      dd_nodes: int = 30,
                      verbose: bool = False) -> MIPGapResult:
    """End-to-end certified MIP gap for a two-stage integer problem:

      1. LP-relaxed PH for (W, xbar);
      2. candidate first stages (rounded xbar, slam-max/min, a few
         scenario vectors, a few scenarios' own exact-MIP first stages),
         ranked by LP-recourse evaluation;
      3. candidates MIP-evaluated in that order (certified inner bound);
      4. the Lagrangian MIP bound at W (+ optional dual ascent steps);
      5. while the gap exceeds `target_gap`: first-stage branch-and-bound
         over the decomposition (decomposition_bnb), up to dd_nodes.

    The reference runs this as hub + xhatshuffle + Lagrangian spokes with
    exact MIP subproblems (ref:mpisppy/generic_cylinders.py:109-312)."""
    require_unsharded(batch, "mip.certified_mip_gap")
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.algos import xhat as xhat_mod

    ph_options = ph_options or ph_mod.PHOptions(max_iterations=50)
    driver = ph_mod.PH(ph_options, batch)
    conv, _, trivial = driver.ph_main()
    st = driver.state

    # -- candidates --------------------------------------------------------
    x_non = batch.nonants(st.solver.x)
    cands = [xhat_mod.round_integers(batch, st.xbar_nodes[0])]
    cands.append(xhat_mod.slam_candidate(batch, x_non, sense_max=True))
    cands.append(xhat_mod.slam_candidate(batch, x_non, sense_max=False))
    S = batch.num_real
    for s in range(min(n_shuffle, S)):
        cands.append(xhat_mod.round_integers(batch, x_non[s]))
    # wait-and-see INTEGER candidates: a few scenarios' own exact-MIP
    # first stages (one batched B&B on a slice of the batch)
    k_ws = min(S, 8)
    qp0 = batch.qp
    qp_ws = dataclasses.replace(
        qp0, c=qp0.c[:k_ws], q=qp0.q[:k_ws], A=_head(qp0.A, k_ws, 3),
        bl=_head(qp0.bl, k_ws, 2), bu=_head(qp0.bu, k_ws, 2),
        l=_head(qp0.l, k_ws, 2), u=_head(qp0.u, k_ws, 2))
    ws = _dispatch.solve_mip(qp_ws, _head(batch.d_col, k_ws, 2),
                             _int_cols(batch), opts)
    ws_x = _host(ws.x)[:, _host(batch.nonant_idx)]
    ws_feas = _host(ws.feasible)
    int_slot = _host(batch.integer_slot)
    seen_keys = set()
    for s in range(k_ws):
        if not ws_feas[s]:
            continue
        # round only the INTEGER slots
        cand = np.where(int_slot, np.round(ws_x[s]), ws_x[s])
        key = tuple(np.round(cand[int_slot]).astype(int))
        if key in seen_keys:
            continue
        seen_keys.add(key)
        cands.append(_as_tensor(batch, cand.astype(np.float32)))
    lp_vals = [float(xhat_mod.evaluate(batch, c, opts.lp).value)
               for c in cands]
    order = np.argsort(lp_vals)

    # -- certified inner: MIP-evaluate candidates in LP rank order, a few
    #    past the first success -------------------------------------------
    inner, xhat_best = float("inf"), _host(cands[int(order[0])])
    n_eval = 0
    for i in order:
        ev = evaluate_mip(batch, cands[int(i)], opts)
        n_eval += 1
        if ev["feasible"] and ev["value"] < inner:
            inner, xhat_best = ev["value"], ev["xhat"]
        if np.isfinite(inner) and n_eval >= 3:
            break

    # -- certified outer ---------------------------------------------------
    if ascent_steps > 0:
        asc = mip_dual_ascent(batch, st.W, st.rho, ascent_steps, opts)
        outer, W_best = asc["bound"], asc["W"]
    else:
        outer = lagrangian_mip_bound(batch, st.W, opts)["bound"]
        W_best = st.W

    gap = (inner - outer) / max(1.0, abs(inner))

    # -- close the duality gap with first-stage branching ------------------
    if gap > target_gap and dd_nodes > 0 and bool(int_slot.any()):
        dd = decomposition_bnb(batch, W_best, opts, max_nodes=dd_nodes,
                               target_gap=target_gap, inner0=inner,
                               xhat0=xhat_best, verbose=verbose)
        inner = min(inner, dd["inner"])
        outer = max(outer, dd["outer"])
        if dd["xhat"] is not None and dd["inner"] <= inner:
            xhat_best = dd["xhat"]
        gap = (inner - outer) / max(1.0, abs(inner))

    return MIPGapResult(inner=inner, outer=outer, gap=gap, xhat=xhat_best,
                        trivial_bound=trivial, ph_conv=conv)
