###############################################################################
# Batched branch-and-bound on the PDHG LP/QP solver: the exact-MIP path
# (port of mpisppy_tpu/ops/bnb.py).
#
# The reference gets exact integer solves from Gurobi/CPLEX per scenario
# subproblem (ref:mpisppy/spopt.py:99-247,884); this module is the MIP
# solver instead:
#
#   * The batch axis is scenarios: every round pops the best-first open
#     node of EVERY scenario's tree and solves all of those LP
#     relaxations as ONE batched PDHG solve — S scenario MIPs advance in
#     lockstep.  On a dense shared A (sslp) each node LP's restart
#     windows run in the window kernel (ops/pdhg.py window_engine).
#   * All control flow is masked tensor math over a fixed-size node pool
#     (S, P, nI); the host runs only the round loop and reads the (S,)
#     done mask.  The JAX package jits a round with its node LP inside
#     (one XLA while loop); here solve() reads `all(done)` once per
#     restart window, so a round is one host loop of windows.
#   * Pruning uses ops.boxqp.certified_dual_bound — valid for ANY
#     iterates by weak duality — so inexact first-order node solves can
#     never fathom the true optimum.  The reported outer bound folds in
#     every fathomed/dropped subtree's bound: the final (inner, outer)
#     bracket is a certificate.
#   * Incumbents come from an integer-feasible leaf, accepted only when
#     the LP's primal residual clears `feas_tol`.
#
# Discrete choices follow the reference's tie rules: argmax/argmin take
# the first index (a bool mask is cast before argmin), top-k is a stable
# descending sort (the lower index first among ties, as jax.lax.top_k),
# round() is half to even and floor(x + 0.5) half up, each where the
# reference has it.  The pool tensors are updated in place: a round
# consumes the state it is given.
#
# Node state per (scenario, pool slot): ORIGINAL-space bounds of the
# integer columns only (the continuous box never changes) and the
# subtree's certified bound.  Ruiz column scalings map the integral
# branching values into the scaled space the solver works in.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.ops import boxqp, pdhg
from mpisppy_tpu_torch.ops.boxqp import BoxQP
from mpisppy_tpu_torch.scengen.random import prng_key, uniform

Tensor = torch.Tensor

# swap_rounds the POLISH entry points (mip.evaluate_mip_polished and the
# other final-candidate certifications) enable explicitly
POLISH_SWAP_ROUNDS = 24

# the jitter's draw is uniform(prng_key(JITTER_SEED)), the JAX package's
# jax.random.uniform(PRNGKey(17)) bit for bit
JITTER_SEED = 17

_INF = float("inf")


# A batch's host loops (the dive's waves, the pump's cycle breaks and
# exit, the swap repair's exit, the round loop's exit) and the SOS1
# detection decide on ALL of its lanes.  `sync` makes those decisions
# over a scenario mesh's lanes (algos/mip.py passes its batch's,
# parallel/mesh.py): each rank's lanes then run the rounds the whole
# axis runs.  Its reduce(t, op) finishes a lane reduction ("min", "max",
# "sum") elementwise over the mesh; rows = (offset, per, total) places
# the lanes on the axis (lns_repair's per-lane draws).  None: this
# batch's lanes are all.
def _all(sync, t: Tensor) -> bool:
    t = t.all()
    return bool(t if sync is None else sync.reduce(t, "min"))


def _count(sync, t: Tensor) -> int:
    t = t.sum()
    return int(t if sync is None else sync.reduce(t, "sum"))


@dataclasses.dataclass(frozen=True)
class BnBOptions:
    """Branch-and-bound options (frozen and hashable: the dispatch
    scheduler keys its coalescing windows on them).  See the JAX package
    for the rationale of each default: the node LP is looser than a
    standalone solve (certified_dual_bound stays valid at any
    tolerance); feas_tol/int_tol sit an order above the LP tol."""

    gap_tol: float = 1e-3       # terminate at (inner-outer) <= gap_tol*scale
    int_tol: float = 1e-4       # max |x - round(x)| to accept integrality
    feas_tol: float = 1e-4      # relative primal residual for incumbents
    pool_size: int = 64         # open-node slots per scenario
    max_rounds: int = 400       # outer (host) round budget
    dive_rounds: int = 16       # confident-wave rounds in the dive pass
    dive_tol: float = 0.1       # "near-integral" fixing threshold
    dive_tail: int = 96         # one-at-a-time rounds for ambiguous cols
    # nearly-integral branched nodes (maxfrac <= pin_frac_tol) also
    # enqueue a "pin" probe with every integer column fixed at its
    # half-up rounding: its solve yields an exact incumbent
    pin_frac_tol: float = 0.05
    # plunge tie tolerance (relative): among nodes within this of the
    # best bound the DEEPEST is popped (search order only)
    plunge_tol: float = 1e-3
    # objective-feasibility-pump rounds after the dive (0 disables)
    pump_rounds: int = 25
    # dual-guided SOS1 swap-repair rounds on integral incumbents: 0 =
    # auto (off, except the polish entry points, which promote it to
    # POLISH_SWAP_ROUNDS); positive is honored everywhere; negative
    # forces it off
    swap_rounds: int = 0
    # deterministic relative objective jitter for the NODE SOLVES only
    # (bounds and objectives always use the true costs); default off
    jitter: float = 0.0
    lp: pdhg.PDHGOptions = pdhg.PDHGOptions(tol=1e-5, max_iters=8_000)


@dataclasses.dataclass(frozen=True)
class BnBState:
    pool_lo: Tensor       # (S, P, nI) original-space int lower bounds
    pool_hi: Tensor       # (S, P, nI)
    pool_bound: Tensor    # (S, P) certified subtree lower bound (+inf empty)
    pool_active: Tensor   # (S, P) bool
    pool_depth: Tensor    # (S, P) int32 tree depth (plunge tie-break)
    incumbent: Tensor     # (S,) best integer-feasible objective (+inf none)
    x_inc: Tensor         # (S, n) incumbent solution, ORIGINAL space
    fathom_floor: Tensor  # (S,) min bound over fathomed subtrees (+inf)
    lost_bound: Tensor    # (S,) min bound over pool-overflow drops (+inf)
    x_warm: Tensor        # (S, n) scaled-space warm start
    y_warm: Tensor        # (S, m)
    omega_warm: Tensor    # (S,) adapted PDHG primal weight, carried over
    Lnorm: Tensor         # (S,) ||A||_2 (bounds never change A)
    outer: Tensor         # (S,) certified global lower bound
    done: Tensor          # (S,) bool
    nodes_solved: Tensor  # (S,) int32


@dataclasses.dataclass(frozen=True)
class BnBResult:
    x: Tensor             # (S, n) best integer solution, ORIGINAL space
    inner: Tensor         # (S,) its objective (+inf if none found)
    outer: Tensor         # (S,) certified lower bound
    gap: Tensor           # (S,) relative certified gap
    feasible: Tensor      # (S,) bool — an integer-feasible point was found
    nodes_solved: Tensor  # (S,) int32


def _cols(int_cols, device) -> Tensor:
    """Integer column indices as an int64 tensor on `device`."""
    if isinstance(int_cols, Tensor):
        return int_cols.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(int_cols, np.int64), device=device)


def _node_qp(qp: BoxQP, d_col: Tensor, int_cols: Tensor,
             lo: Tensor, hi: Tensor) -> BoxQP:
    """Base qp with the integer columns' box replaced by the node's
    ORIGINAL-space [lo, hi] (mapped through the column scaling)."""
    S, n = qp.c.shape
    l_full = torch.broadcast_to(qp.l, (S, n)).clone()
    u_full = torch.broadcast_to(qp.u, (S, n)).clone()
    d_int = torch.broadcast_to(d_col, (S, n))[:, int_cols]
    l_full[:, int_cols] = lo / d_int
    u_full[:, int_cols] = hi / d_int
    return dataclasses.replace(qp, l=l_full, u=u_full)


def _solve_node(qp_node: BoxQP, x_warm: Tensor, y_warm: Tensor,
                lp_opts: pdhg.PDHGOptions,
                omega: Tensor | None = None, Lnorm: Tensor | None = None,
                jitter: float = 0.0):
    """Batched LP solve of the current nodes, warm-started (iterates and
    the step machinery: omega and the one-time ||A|| estimate carry
    across nodes, since branching only moves bounds, never A).

    `jitter` perturbs the SOLVE's costs by a fixed pseudorandom relative
    amount; the returned objective, certified bound and residuals are
    evaluated against the TRUE qp_node.
    Returns (solver_state, objective, certified_lb, primal_residual)."""
    lp = dataclasses.replace(lp_opts, detect_infeas=True)
    if jitter > 0.0:
        # per-row draws: tiled multistart copies of one scenario get
        # different tie-breaks from the same key
        u = uniform(prng_key(JITTER_SEED, device=qp_node.c.device),
                    tuple(qp_node.c.shape))
        cscale = torch.clamp(qp_node.c.abs().mean(dim=-1, keepdim=True),
                             min=1.0)
        qp_solve = dataclasses.replace(
            qp_node, c=qp_node.c + jitter * cscale * (u - 0.5))
    else:
        qp_solve = qp_node
    x0 = torch.clamp(x_warm, qp_node.l, qp_node.u)
    if omega is None or Lnorm is None:
        st0 = pdhg.init_state(qp_solve, lp, x0=x0, y0=y_warm)
    else:
        bs = tuple(qp_node.c.shape[:-1])
        dt, dev = qp_node.c.dtype, qp_node.c.device

        def full(v, dtype=dt):
            return torch.full(bs, v, dtype=dtype, device=dev)

        st0 = pdhg.PDHGState(
            x=x0, y=y_warm,
            x_sum=torch.zeros_like(x0), y_sum=torch.zeros_like(y_warm),
            x_anchor=x0, y_anchor=y_warm, omega=omega, Lnorm=Lnorm, k=0,
            nwin=full(0, torch.int32), restart_score=full(_INF),
            score=full(_INF), done=full(False, torch.bool),
            status=full(0, torch.int32), guard_resets=full(0, torch.int32))
    sol = pdhg.solve(qp_solve, lp, st0)
    obj = torch.sum(qp_node.c * sol.x + 0.5 * qp_node.q * sol.x * sol.x,
                    dim=-1)
    lb = boxqp.certified_dual_bound(qp_node, sol.x, sol.y)
    rp, _, _ = boxqp.kkt_residuals(qp_node, sol.x, sol.y)
    return sol, obj, lb, rp


def _lp_feasible(sol, rp, feas_tol: float) -> Tensor:
    return (rp <= feas_tol) & (sol.status != pdhg.INFEASIBLE) \
        & (sol.status != pdhg.UNBOUNDED)


def _first_false(mask: Tensor) -> Tensor:
    """argmin of a bool mask (the first False; 0 when none)."""
    return torch.argmin(mask.to(torch.int8), dim=1)


def bnb_round(qp: BoxQP, d_col: Tensor, int_cols, st: BnBState,
              opts: BnBOptions) -> BnBState:
    """One best-first round: pop each scenario's lowest-bound open node,
    solve the batch of LP relaxations, then fathom/branch per scenario.
    The pool tensors of `st` are updated in place."""
    S, P, nI = st.pool_lo.shape
    dev, dt = qp.c.device, qp.c.dtype
    int_cols = _cols(int_cols, dev)
    inf = torch.tensor(_INF, dtype=dt, device=dev)
    rows = torch.arange(S, device=dev)

    # PLUNGING selection: among active nodes whose bound ties the best
    # (within a relative epsilon), pop the DEEPEST
    key = torch.where(st.pool_active, st.pool_bound, inf)
    bmin = key.amin(dim=1, keepdim=True)
    tie_eps = opts.plunge_tol * torch.clamp(bmin.abs(), min=1.0)
    thresh = torch.where(torch.isfinite(bmin), bmin + tie_eps, inf)
    tied = st.pool_active & (key <= thresh)
    sel = torch.argmax(torch.where(tied, st.pool_depth,
                                   torch.full_like(st.pool_depth, -1)),
                       dim=1)                              # (S,)
    has = st.pool_active.any(dim=1) & ~st.done             # (S,)
    sel_oh = torch.nn.functional.one_hot(sel, P).bool()    # (S, P)

    lo = st.pool_lo[rows, sel]
    hi = st.pool_hi[rows, sel]
    parent = st.pool_bound[rows, sel]

    qpn = _node_qp(qp, d_col, int_cols, lo, hi)
    sol, obj, lb, rp = _solve_node(qpn, st.x_warm, st.y_warm, opts.lp,
                                   st.omega_warm, st.Lnorm,
                                   jitter=opts.jitter)
    box_ok = (lo <= hi).all(dim=1)
    infeas = (sol.status == pdhg.INFEASIBLE) | ~box_ok
    lb = torch.where(infeas, inf, torch.maximum(lb, parent))

    x_orig = sol.x * torch.broadcast_to(d_col, sol.x.shape)
    xi = x_orig[:, int_cols]
    frac = (xi - torch.round(xi)).abs()
    maxfrac = frac.amax(dim=1)
    feas = rp <= opts.feas_tol
    is_int = has & (maxfrac <= opts.int_tol) & feas & ~infeas

    # -- incumbent ---------------------------------------------------------
    better = is_int & (obj < st.incumbent)
    incumbent = torch.where(better, obj, st.incumbent)
    x_inc = torch.where(better[:, None], x_orig, st.x_inc)

    # -- fathoming ---------------------------------------------------------
    scale = torch.clamp(incumbent.abs(), min=1.0)
    thresh = torch.where(torch.isfinite(incumbent),
                         incumbent - opts.gap_tol * scale, inf)
    prune = has & ~is_int & ~infeas & (lb >= thresh)
    fathomed = has & (is_int | prune)
    fathom_floor = torch.where(fathomed,
                               torch.minimum(st.fathom_floor, lb),
                               st.fathom_floor)
    branch = has & ~is_int & ~prune & ~infeas

    # -- branch: the rounded child replaces the popped slot, the other
    #    goes to a free slot (or evicts the worst open node) --------------
    jstar = torch.argmax(frac, dim=1)                      # (S,)
    j_oh = torch.nn.functional.one_hot(jstar, nI).bool()
    v = xi[rows, jstar]
    fl = torch.floor(v)
    hi_down = torch.where(j_oh, fl[:, None], hi)
    lo_up = torch.where(j_oh, fl[:, None] + 1.0, lo)
    round_up = ((v - fl) >= 0.5)[:, None]
    sel_lo = torch.where(round_up, lo_up, lo)
    sel_hi = torch.where(round_up, hi, hi_down)
    oth_lo = torch.where(round_up, lo, lo_up)
    oth_hi = torch.where(round_up, hi_down, hi)

    pool_lo, pool_hi = st.pool_lo, st.pool_hi
    b2 = branch[:, None]
    depth = st.pool_depth[rows, sel]
    child_depth = depth + 1
    pool_lo[rows, sel] = torch.where(b2, sel_lo, lo)
    pool_hi[rows, sel] = torch.where(b2, sel_hi, hi)
    m_sel = sel_oh & b2
    pool_bound = torch.where(m_sel, lb[:, None], st.pool_bound)
    pool_depth = torch.where(m_sel, child_depth[:, None], st.pool_depth)
    closed = sel_oh & (has & ~branch)[:, None]
    pool_active = st.pool_active & ~closed

    # free slot for the other child: first inactive, else evict the
    # worst open node
    any_free = (~pool_active).any(dim=1)
    first_free = _first_false(pool_active)
    worst = torch.argmax(torch.where(pool_active, pool_bound, -inf), dim=1)
    slot_up = torch.where(any_free, first_free, worst)
    up_oh = torch.nn.functional.one_hot(slot_up, P).bool() & b2
    evict = branch & ~any_free
    evicted_bound = pool_bound[rows, worst]
    lost_bound = torch.where(evict,
                             torch.minimum(st.lost_bound, evicted_bound),
                             st.lost_bound)
    pool_lo[rows, slot_up] = torch.where(b2, oth_lo, pool_lo[rows, slot_up])
    pool_hi[rows, slot_up] = torch.where(b2, oth_hi, pool_hi[rows, slot_up])
    pool_bound = torch.where(up_oh, lb[:, None], pool_bound)
    pool_depth = torch.where(up_oh, child_depth[:, None], pool_depth)
    pool_active = pool_active | up_oh

    # -- pin probe: near-integral branched nodes also enqueue the fully
    #    rounded assignment, only into a genuinely free slot -------------
    want_pin = branch & (maxfrac <= opts.pin_frac_tol)
    free_pin = (~pool_active).any(dim=1)
    slot_pin = _first_false(pool_active)
    pin = (want_pin & free_pin)[:, None]
    pin_oh = torch.nn.functional.one_hot(slot_pin, P).bool() & pin
    r_pin = torch.clamp(torch.floor(xi + 0.5), lo, hi)
    pool_lo[rows, slot_pin] = torch.where(pin, r_pin,
                                          pool_lo[rows, slot_pin])
    pool_hi[rows, slot_pin] = torch.where(pin, r_pin,
                                          pool_hi[rows, slot_pin])
    pool_bound = torch.where(pin_oh, lb[:, None], pool_bound)
    # probes outrank both children in the plunge order
    pool_depth = torch.where(pin_oh, child_depth[:, None] + 1, pool_depth)
    pool_active = pool_active | pin_oh

    # -- certified global outer bound + termination ------------------------
    open_min = torch.where(pool_active, pool_bound, inf).amin(dim=1)
    outer = torch.minimum(torch.minimum(open_min, fathom_floor),
                          torch.minimum(lost_bound, incumbent))
    gap_ok = (incumbent - outer) <= opts.gap_tol \
        * torch.clamp(incumbent.abs(), min=1.0)
    done = st.done | ~pool_active.any(dim=1) \
        | (torch.isfinite(incumbent) & gap_ok)

    return BnBState(
        pool_lo=pool_lo, pool_hi=pool_hi, pool_bound=pool_bound,
        pool_active=pool_active, pool_depth=pool_depth,
        incumbent=incumbent, x_inc=x_inc,
        fathom_floor=fathom_floor, lost_bound=lost_bound,
        x_warm=sol.x, y_warm=sol.y, omega_warm=sol.omega, Lnorm=st.Lnorm,
        outer=outer, done=done,
        nodes_solved=st.nodes_solved + has.to(torch.int32),
    )


# --------------------------------------------------------------------------
# Objective feasibility pump (Fischetti-Glover-Lodi; objective variant of
# Achterberg-Berthold): alternate
#     x_lp  = argmin  (alpha) c'x + (1-alpha) dist(x, x_int)
#     x_int = round(x_lp)                 (half-up)
# with alpha decaying; cycles break by flipping the most fractional
# entries.  Every iteration is ONE batched warm LP solve.
# --------------------------------------------------------------------------
def pump_round(qp: BoxQP, d_col: Tensor, int_cols, xint: Tensor,
               alpha: Tensor, x_warm: Tensor, y_warm: Tensor,
               omega: Tensor, Lnorm: Tensor, opts: BnBOptions):
    """One pump iteration at mixing weight alpha ((S,) in [0,1]).
    Returns (xi, frac, x, y, omega), xi the new LP's integer columns in
    original space."""
    S, n = qp.c.shape
    int_cols = _cols(int_cols, qp.c.device)
    d_int = torch.broadcast_to(d_col, (S, n))[:, int_cols]
    # distance objective in SCALED space: d/dx |d*x - xint| = +-d
    l_int = torch.broadcast_to(qp.l, (S, n))[:, int_cols]
    lo_side = xint <= torch.ceil(l_int * d_int - 1e-6)
    sgn = torch.where(lo_side, 1.0, -1.0).to(qp.c.dtype)
    c_dist = torch.zeros((S, n), dtype=qp.c.dtype, device=qp.c.device)
    c_dist[:, int_cols] = sgn * d_int
    cn = qp.c / torch.clamp(torch.linalg.vector_norm(qp.c, dim=-1,
                                                     keepdim=True), min=1e-12)
    dn = c_dist / torch.clamp(torch.linalg.vector_norm(c_dist, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    a = alpha[:, None]
    qp_pump = dataclasses.replace(qp, c=a * cn + (1.0 - a) * dn)
    sol, _, _, _ = _solve_node(qp_pump, x_warm, y_warm, opts.lp, omega,
                               Lnorm)
    x_orig = sol.x * torch.broadcast_to(d_col, sol.x.shape)
    xi = x_orig[:, int_cols]
    frac = (xi - torch.round(xi)).abs()
    return xi, frac, sol.x, sol.y, sol.omega


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, Tensor) \
        else np.asarray(t)


def feasibility_pump(qp: BoxQP, d_col: Tensor, int_cols,
                     opts: BnBOptions = BnBOptions(),
                     rounds: int = 40, alpha_decay: float = 0.85,
                     x_warm: Tensor | None = None,
                     y_warm: Tensor | None = None,
                     omega: Tensor | None = None,
                     Lnorm: Tensor | None = None, sync=None):
    """Batched objective feasibility pump.  Returns (value (S,),
    x (S, n) original space, feasible (S,)) for the BEST integer point
    each scenario's pump visited (evaluated by pinning the rounding and
    solving the true-objective LP)."""
    S, n = qp.c.shape
    dt, dev = qp.c.dtype, qp.c.device
    int_cols = _cols(int_cols, dev)
    if x_warm is None:
        x_warm = torch.clamp(torch.zeros((S, n), dtype=dt, device=dev),
                             qp.l, qp.u)
    if y_warm is None:
        y_warm = torch.zeros((S, qp.m), dtype=dt, device=dev)
    if omega is None:
        omega = torch.full((S,), opts.lp.omega0, dtype=dt, device=dev)
    if Lnorm is None:
        Lnorm = pdhg.estimate_norm(qp, opts.lp.power_iters).to(dt)

    lo0_np, hi0_np = _root_bounds(qp, d_col, _np(int_cols))
    lo0 = torch.as_tensor(lo0_np, dtype=dt, device=dev)
    hi0 = torch.as_tensor(hi0_np, dtype=dt, device=dev)
    # the root LP under the true objective seeds the rounding
    qpr = _node_qp(qp, d_col, int_cols, lo0, hi0)
    sol, _, _, _ = _solve_node(qpr, x_warm, y_warm, opts.lp, omega, Lnorm)
    x_warm, y_warm, omega = sol.x, sol.y, sol.omega
    xi = (sol.x * torch.broadcast_to(d_col, sol.x.shape))[:, int_cols]
    xint = torch.clamp(torch.floor(xi + 0.5), lo0, hi0)

    best_val = torch.full((S,), _INF, dtype=dt, device=dev)
    best_x = torch.zeros((S, n), dtype=dt, device=dev)
    alpha = torch.ones((S,), dtype=dt, device=dev)
    prev_key = None
    rng = np.random.RandomState(23)
    for _ in range(rounds):
        alpha = alpha * alpha_decay
        xi, frac, x_warm, y_warm, omega = pump_round(
            qp, d_col, int_cols, xint, alpha, x_warm, y_warm, omega,
            Lnorm, opts)
        new_xint = torch.clamp(torch.floor(xi + 0.5), lo0, hi0)
        # evaluate the CURRENT rounding: one true-objective solve of the
        # fully pinned LP
        qp_pin = _node_qp(qp, d_col, int_cols, new_xint, new_xint)
        psol, pobj, _, prp = _solve_node(qp_pin, x_warm, y_warm, opts.lp,
                                         omega, Lnorm)
        val = torch.where(_lp_feasible(psol, prp, opts.feas_tol), pobj,
                          torch.full_like(pobj, _INF))
        x_f = psol.x * torch.broadcast_to(d_col, psol.x.shape)
        better = val < best_val
        best_val = torch.where(better, val, best_val)
        best_x = torch.where(better[:, None], x_f, best_x)
        # cycle break: if the rounding did not change, flip the most
        # fractional entries (deterministic count, seeded)
        key_now = _np(new_xint)
        fr = _np(frac)
        if prev_key is not None and _all(
                sync, torch.as_tensor(key_now == prev_key)):
            nflip = 1 + rng.randint(0, 4)
            idx = np.argsort(-fr, axis=1)[:, :nflip]
            flip = np.array(key_now)
            for s in range(S):
                cols = idx[s]
                lo_s = lo0_np[s, cols]
                hi_s = hi0_np[s, cols]
                flip[s, cols] = np.where(flip[s, cols] <= lo_s,
                                         np.minimum(lo_s + 1, hi_s),
                                         np.maximum(flip[s, cols] - 1,
                                                    lo_s))
            new_xint = torch.as_tensor(flip, dtype=dt, device=dev)
        prev_key = _np(new_xint)
        xint = new_xint
        if _all(sync, torch.isfinite(best_val)) \
                and _all(sync, torch.as_tensor(fr.max(axis=1) < 1e-3)):
            break
    return best_val, best_x, torch.isfinite(best_val)


# --------------------------------------------------------------------------
# Dive heuristic: fix-and-round to a full integer assignment.
# --------------------------------------------------------------------------
def detect_sos1_groups(qp: BoxQP, d_col: Tensor, int_cols, sync=None):
    """Host-side detection of SOS1-like equality rows: bl == bu, every
    nonzero on an INTEGER column, and (in ORIGINAL space) each
    coefficient equal to the row rhs — rows sum_j y_j = h with y binary,
    h in {0, 1} (sslp's assignment rows), which independent per-column
    rounding wrecks; the dive projects them winner-take-all instead.

    Returns (groups (G, L) int64 positions into int_cols padded with -1,
    active (S, G) bool: rhs ~= coefficient for that scenario), both on
    the problem's device, or (None, None) when no groups exist.  With
    `sync` the rows are those of the mesh's whole lane axis."""
    A = qp.A
    if hasattr(A, "vals"):  # ELL: reconstruct rows over int cols
        A2 = A.toarray()
        if A2.ndim == 3:
            A2 = A2[0]
    else:
        A2 = _np(A)
        if A2.ndim == 3:
            A2 = A2[0]
    S = qp.c.shape[0]
    n = qp.c.shape[-1]
    dcol = np.broadcast_to(_np(d_col), (S, n))[0]
    bl = np.broadcast_to(_np(qp.bl), (S, qp.m))
    bu = np.broadcast_to(_np(qp.bu), (S, qp.m))
    int_cols_np = _np(int_cols)
    is_int = np.zeros(n, bool)
    is_int[int_cols_np] = True
    pos_of = np.full(n, -1, np.int64)
    pos_of[int_cols_np] = np.arange(len(int_cols_np))
    eq = np.all(np.abs(bl - bu) <= 1e-9, axis=0)  # equality in every scen
    if sync is not None:
        eq = sync.reduce(torch.as_tensor(eq), "min").cpu().numpy()
    groups, actives = [], []
    # A2[i, j] / d_col_j == d_row_i * orig coef and bl[s, i] == d_row_i *
    # orig rhs: their equality is orig coef == orig rhs
    for i in range(qp.m):
        if not eq[i]:
            continue
        nz = np.nonzero(np.abs(A2[i]) > 1e-12)[0]
        if nz.size < 2 or not np.all(is_int[nz]):
            continue
        coefs = A2[i, nz] / dcol[nz]
        if np.abs(coefs - coefs[0]).max() > 1e-6 * max(1.0, abs(coefs[0])):
            continue
        act = np.abs(bl[:, i] - coefs[0]) <= 1e-6 * max(1.0, abs(coefs[0]))
        groups.append(pos_of[nz])
        actives.append(act)
    # a group active in some scenario (of the whole axis)
    live = np.asarray([a.any() for a in actives], bool)
    if sync is not None and live.size:
        live = sync.reduce(torch.as_tensor(live), "max").cpu().numpy()
    groups = [g for g, on in zip(groups, live) if on]
    actives = [a for a, on in zip(actives, live) if on]
    if not groups:
        return None, None
    L = max(len(g) for g in groups)
    gm = np.full((len(groups), L), -1, np.int64)
    for gi, g in enumerate(groups):
        gm[gi, :len(g)] = g
    dev = qp.c.device
    return (torch.as_tensor(gm, device=dev),
            torch.as_tensor(np.asarray(actives).T.copy(), device=dev))


def _membership(groups: Tensor, nI: int) -> Tensor:
    """(G, nI) bool: column position j belongs to group g."""
    valid = groups >= 0
    m = torch.zeros((groups.shape[0], nI + 1), dtype=torch.bool,
                    device=groups.device)
    m.scatter_(1, torch.where(valid, groups, nI), True)
    return m[:, :nI]


def _sos1_project(r: Tensor, xi: Tensor, lo: Tensor, hi: Tensor,
                  groups: Tensor, active: Tensor) -> Tensor:
    """Winner-take-all rounding targets on SOS1 groups: the member with
    the largest LP value gets 1, the rest 0 (fixed-at-1 members win
    outright).  r/xi/lo/hi: (S, nI); groups (G, L) padded -1;
    active (S, G)."""
    S, nI = r.shape
    gidx = torch.where(groups < 0, 0, groups)         # (G, L) safe gather
    valid = (groups >= 0)[None, :, :]                 # (1, G, L)
    xi_g = xi[:, gidx]                                # (S, G, L)
    lo_g = lo[:, gidx]
    hi_g = hi[:, gidx]
    fixed1 = (lo_g == hi_g) & (lo_g > 0.5) & valid
    score = torch.where(valid, xi_g, -_INF)
    score = torch.where(fixed1, _INF, score)          # fixed-at-1 wins
    winner = torch.argmax(score, dim=-1)              # (S, G)
    onehot = torch.nn.functional.one_hot(
        winner, groups.shape[1]).to(r.dtype)          # (S, G, L)
    apply = valid & active[:, :, None]
    # only APPLIED positions overwrite r (the others go to a spare column)
    dest = torch.where(apply, gidx[None], nI).reshape(S, -1)
    r2 = torch.cat([r, torch.zeros_like(r[:, :1])], dim=1)
    r2.scatter_(1, dest, onehot.reshape(S, -1))
    return r2[:, :nI]


def dive_round(qp: BoxQP, d_col: Tensor, int_cols,
               lo: Tensor, hi: Tensor, x_warm: Tensor, y_warm: Tensor,
               omega: Tensor, Lnorm: Tensor,
               opts: BnBOptions, mode: str = "wave", sos1=None):
    """Solve the current partially-fixed LP, then pin integer columns.

    mode="wave":   pin up to ~nI/8 CONFIDENT columns (frac <= dive_tol);
    mode="group":  pin ONE whole SOS1 group (the clearest winner);
    mode="single": pin exactly the most integral unfixed column;
    mode="final":  pin everything remaining (the closing solve).

    Returns updated (lo, hi, x, y, omega, obj, feasible)."""
    int_cols = _cols(int_cols, qp.c.device)
    qpn = _node_qp(qp, d_col, int_cols, lo, hi)
    sol, obj, _, rp = _solve_node(qpn, x_warm, y_warm, opts.lp,
                                  omega, Lnorm, jitter=opts.jitter)
    x_orig = sol.x * torch.broadcast_to(d_col, sol.x.shape)
    xi = x_orig[:, int_cols]
    frac = (xi - torch.round(xi)).abs()
    fixed = lo == hi
    S, nI = frac.shape
    has_sos1 = sos1 is not None and sos1[0] is not None
    # members of ACTIVE SOS1 groups are resolved only by group mode
    sos_member = None
    if has_sos1:
        groups_, active_ = sos1
        membership_ = _membership(groups_, nI).to(frac.dtype)
        sos_member = (active_.to(frac.dtype) @ membership_) > 0.5

    if mode == "final":
        newfix = ~fixed
    elif mode == "group":
        groups, active = sos1
        G = groups.shape[0]
        gidx = torch.where(groups < 0, 0, groups)
        valid = (groups >= 0)[None]
        fixed_g = fixed[:, gidx] & valid
        unresolved = (~fixed_g & valid).any(dim=-1) & active
        xi_g = torch.where(valid, xi[:, gidx], -_INF)
        conf = torch.where(fixed_g, -_INF, xi_g).amax(dim=-1)
        conf = torch.where(unresolved, conf, -_INF)
        gstar = torch.argmax(conf, dim=-1)                 # (S,)
        has = unresolved.any(dim=-1)
        sel = torch.nn.functional.one_hot(gstar, G).to(frac.dtype)
        mem = (sel @ _membership(groups, nI).to(frac.dtype)) > 0.5
        newfix = mem & ~fixed & has[:, None]
    elif mode == "single":
        blocked = fixed if sos_member is None else (fixed | sos_member)
        jstar = torch.argmin(torch.where(blocked, _INF, frac), dim=1)
        has_unfixed = ~blocked.all(dim=1)
        newfix = torch.nn.functional.one_hot(jstar, nI).bool() \
            & has_unfixed[:, None] & ~fixed
    else:
        K = max(1, nI // 8)
        blocked = fixed if sos_member is None else (fixed | sos_member)
        score = torch.where(blocked, -_INF, -frac)         # bigger = better
        # the K smallest fracs, the lower index first among ties
        vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :K], idx[:, :K]
        take = vals > -opts.dive_tol                       # confident only
        newfix = torch.zeros_like(fixed)
        newfix.scatter_(1, idx, take)
        newfix = newfix & ~fixed
    r = torch.clamp(torch.floor(xi + 0.5), lo, hi)
    if has_sos1:
        groups, active = sos1
        r = torch.clamp(_sos1_project(r, xi, lo, hi, groups, active), lo, hi)
    lo2 = torch.where(newfix, r, lo)
    hi2 = torch.where(newfix, r, hi)
    feasible = _lp_feasible(sol, rp, opts.feas_tol)
    return lo2, hi2, sol.x, sol.y, sol.omega, obj, feasible


def _root_bounds(qp: BoxQP, d_col: Tensor, int_cols: np.ndarray):
    """ORIGINAL-space integral root box of the integer columns (host
    f32 arrays, the JAX package's numpy arithmetic)."""
    S, n = qp.c.shape
    l_orig = np.broadcast_to(_np(qp.l), (S, n)) \
        * np.broadcast_to(_np(d_col), (S, n))
    u_orig = np.broadcast_to(_np(qp.u), (S, n)) \
        * np.broadcast_to(_np(d_col), (S, n))
    lo = np.ceil(l_orig[:, int_cols] - 1e-6)
    hi = np.floor(u_orig[:, int_cols] + 1e-6)
    return lo, hi


def dive(qp: BoxQP, d_col: Tensor, int_cols,
         opts: BnBOptions = BnBOptions(),
         lo: Tensor | None = None, hi: Tensor | None = None,
         x_warm: Tensor | None = None, y_warm: Tensor | None = None,
         omega: Tensor | None = None, Lnorm: Tensor | None = None,
         sos1=None, sync=None):
    """Fix-and-round dive to one integer-feasible point per scenario
    (host loop over rounds).  Returns (value (S,), x (S,n) orig,
    feasible (S,), warm) where warm = (x, y, omega, Lnorm) for reuse;
    value is +inf where the dive's end point is infeasible."""
    S, n = qp.c.shape
    dt, dev = qp.c.dtype, qp.c.device
    int_cols = _cols(int_cols, dev)
    if lo is None or hi is None:
        lo_np, hi_np = _root_bounds(qp, d_col, _np(int_cols))
        lo = torch.as_tensor(lo_np, dtype=dt, device=dev)
        hi = torch.as_tensor(hi_np, dtype=dt, device=dev)
    if x_warm is None:
        x_warm = torch.clamp(torch.zeros((S, n), dtype=dt, device=dev),
                             qp.l, qp.u)
    if y_warm is None:
        y_warm = torch.zeros((S, qp.m), dtype=dt, device=dev)
    if omega is None:
        omega = torch.full((S,), opts.lp.omega0, dtype=dt, device=dev)
    if Lnorm is None:
        Lnorm = pdhg.estimate_norm(qp, opts.lp.power_iters).to(dt)

    def all_fixed():
        return _all(sync, lo == hi)

    # SOS1-like assignment rows round winner-take-all (detected once;
    # repeated callers — lns_repair — pass the cached detection in)
    if sos1 is None:
        sos1 = detect_sos1_groups(qp, d_col, int_cols, sync)

    def step(mode):
        return dive_round(qp, d_col, int_cols, lo, hi, x_warm, y_warm,
                          omega, Lnorm, opts, mode, sos1=sos1)

    prev_fixed = -1
    for _ in range(max(1, opts.dive_rounds)):
        lo, hi, x_warm, y_warm, omega, obj, feas = step("wave")
        nfixed = _count(sync, lo == hi)
        if all_fixed() or nfixed == prev_fixed:  # no confident cols left
            break
        prev_fixed = nfixed
    # SOS1 groups: one whole group per re-solve, clearest winner first
    if sos1[0] is not None:
        for _ in range(int(sos1[0].shape[0])):
            if all_fixed():
                break
            lo, hi, x_warm, y_warm, omega, obj, feas = step("group")
    # ambiguous tail: one pin per re-solve
    for _ in range(opts.dive_tail):
        if all_fixed():
            break
        lo, hi, x_warm, y_warm, omega, obj, feas = step("single")
    # pin any remainder, then one last solve of the fully fixed LP
    lo, hi, x_warm, y_warm, omega, obj, feas = step("final")
    lo, hi, x_warm, y_warm, omega, obj, feas = step("final")
    value = torch.where(feas, obj, torch.full_like(obj, _INF))
    x_orig = x_warm * torch.broadcast_to(d_col, x_warm.shape)
    return value, x_orig, feas, (x_warm, y_warm, omega, Lnorm)


def _swap_round(qp: BoxQP, d_col: Tensor, int_cols: Tensor,
                xi: Tensor, hi_root: Tensor, groups: Tensor, active: Tensor,
                obj_cur: Tensor, feas_cur: Tensor,
                x_cur: Tensor, y_cur: Tensor, omega: Tensor, Lnorm: Tensor,
                opts: BnBOptions):
    """One dual-guided SOS1 swap per scenario (BnBOptions.swap_rounds).
    `xi` is the (S, nI) integral point in ORIGINAL space, x_cur/y_cur
    the scaled primal-dual pair of its all-fixed LP solve; accepted
    moves replace the state, rejected ones leave it unchanged."""
    S = xi.shape[0]
    d_full = torch.broadcast_to(d_col, x_cur.shape)
    # per-unit-original reduced costs off the CURRENT duals: moving a
    # one-hot winner from column w to column m changes the objective by
    # ~ rc[m]/d[m] - rc[w]/d[w]
    rc = qp.c + qp.q * x_cur + qp.rmatvec(y_cur)
    score = (rc / d_full)[:, int_cols]                     # (S, nI)
    gidx = torch.where(groups < 0, 0, groups)              # (G, L)
    valid = (groups >= 0)[None]                            # (1, G, L)
    srange = torch.arange(S, device=xi.device)
    xg = torch.where(valid, xi[:, gidx], 0.0)              # (S, G, L)
    sg = torch.where(valid, score[:, gidx], _INF)
    allowed = valid & (hi_root[:, gidx] > 0.5)
    is_winner = xg > 0.5
    win_score = torch.where(is_winner, sg, 0.0).sum(dim=-1)
    alt = torch.where(is_winner | ~allowed, _INF, sg)      # (S, G, L)
    alt_best = alt.amin(dim=-1)
    has_winner = (is_winner & valid).any(dim=-1)           # (S, G)
    delta = torch.where(active & has_winner & torch.isfinite(alt_best),
                        alt_best - win_score, _INF)
    gstar = torch.argmin(delta, dim=-1)                    # (S,)
    can = torch.isfinite(delta.amin(dim=-1)) & feas_cur
    gsel = gidx[gstar]                                     # (S, L)
    vsel = (groups >= 0)[gstar]
    xg_sel = torch.where(vsel, xi[srange[:, None], gsel], 0.0)
    win_col = torch.gather(gsel, 1,
                           torch.argmax(xg_sel, dim=-1)[:, None])[:, 0]
    alt_sel = alt[srange, gstar]
    alt_col = torch.gather(gsel, 1,
                           torch.argmin(alt_sel, dim=-1)[:, None])[:, 0]
    step = torch.where(can, 1.0, 0.0).to(xi.dtype)
    xi_try = xi.clone()
    xi_try.index_put_((srange, win_col), -step, accumulate=True)
    xi_try.index_put_((srange, alt_col), step, accumulate=True)

    qpt = _node_qp(qp, d_col, int_cols, xi_try, xi_try)
    sol2, obj2, _, rp2 = _solve_node(qpt, x_cur, y_cur, opts.lp,
                                     omega, Lnorm)
    feas2 = _lp_feasible(sol2, rp2, opts.feas_tol)
    eps = 1e-6 * torch.clamp(obj_cur.abs(), min=1.0)
    improve = can & feas2 & (obj2 < obj_cur - eps)
    imp_c = improve[:, None]
    return (torch.where(imp_c, xi_try, xi),
            torch.where(improve, obj2, obj_cur),
            feas_cur | improve,
            torch.where(imp_c, sol2.x, x_cur),
            torch.where(imp_c, sol2.y, y_cur),
            torch.where(improve, sol2.omega, omega),
            improve)


def sos1_swap_repair(qp: BoxQP, d_col: Tensor, int_cols,
                     x_inc_orig: Tensor, feas: Tensor,
                     opts: BnBOptions,
                     warm=None, sos1=None, verbose: bool = False,
                     sync=None):
    """Polish integral incumbents by dual-guided SOS1 winner swaps.

    x_inc_orig: (S, n) incumbent points in ORIGINAL space.  Returns
    (value (S,), x_orig, feasible) with per-scenario improvements only,
    or None when the problem has no SOS1 groups or swap_rounds <= 0."""
    if opts.swap_rounds <= 0:
        return None
    if sos1 is None:
        sos1 = detect_sos1_groups(qp, d_col, int_cols, sync)
    groups, active = sos1
    if groups is None:
        return None
    S, n = qp.c.shape
    dt, dev = qp.c.dtype, qp.c.device
    int_cols = _cols(int_cols, dev)
    _, hi_root = _root_bounds(qp, d_col, _np(int_cols))
    hi_root = torch.as_tensor(hi_root, dtype=dt, device=dev)
    xi = torch.round(x_inc_orig[:, int_cols])
    d_full = torch.broadcast_to(d_col, (S, n))
    if warm is not None:
        x_w, y_w, omega, Lnorm = warm
    else:
        x_w = x_inc_orig.to(dt) / d_full
        y_w = torch.zeros((S, qp.m), dtype=dt, device=dev)
        omega = Lnorm = None
    # evaluate the incumbents once (all integers fixed) for the baseline
    # objective and the duals the first proposals read
    qpn = _node_qp(qp, d_col, int_cols, xi, xi)
    sol, obj, _, rp = _solve_node(qpn, x_w, y_w, opts.lp, omega, Lnorm)
    feas_cur = feas & _lp_feasible(sol, rp, opts.feas_tol)
    x_cur, y_cur, om = sol.x, sol.y, sol.omega
    Ln = sol.Lnorm
    for r in range(opts.swap_rounds):
        xi, obj, feas_cur, x_cur, y_cur, om, moved = _swap_round(
            qp, d_col, int_cols, xi, hi_root, groups, active,
            obj, feas_cur, x_cur, y_cur, om, Ln, opts)
        if _all(sync, ~moved):
            break
        if (r + 1) % 8 == 0:
            global_toc(f"[swap] round {r + 1}: obj={_np(obj)}", verbose)
    x_orig = x_cur * d_full
    x_orig[:, int_cols] = xi
    return (torch.where(feas_cur, obj, torch.full_like(obj, _INF)), x_orig,
            feas_cur)


def merge_incumbents(inc, x_inc, feas, cand_val, cand_x, cand_feas):
    """Accept-only-improvements merge of candidate incumbents into the
    running best: a candidate counts only where IT is feasible and
    strictly better than the current FEASIBLE value (infeasible current
    = +inf)."""
    better = torch.where(cand_feas, cand_val, _INF) \
        < torch.where(feas, inc, _INF)
    return (torch.where(better, cand_val, inc),
            torch.where(better[:, None], cand_x, x_inc),
            feas | (cand_feas & better))


def _tile(x, K: int, nd: int):
    """x repeated K times along its leading (batch) axis when it has
    batched rank `nd` (an EllMatrix tiles its values); shared fields
    pass through."""
    if hasattr(x, "vals"):
        return x.with_vals(_tile(x.vals, K, nd))
    if getattr(x, "ndim", 0) != nd:
        return x
    return x.repeat((K,) + (1,) * (nd - 1))


def dive_multistart(qp: BoxQP, d_col: Tensor, int_cols,
                    opts: BnBOptions = BnBOptions(), K: int = 16,
                    sos1=None, sync=None):
    """K jitter-diversified dives per scenario in ONE batched program:
    each copy solves the SAME scenario with a different deterministic
    objective perturbation (tie-breaking only; values are always
    evaluated against the true costs); the per-scenario best integral
    point wins.  Returns (value (S,), x (S, n) orig, feasible (S,))."""
    S, n = qp.c.shape
    qpK = dataclasses.replace(
        qp, c=_tile(qp.c, K, 2), q=_tile(qp.q, K, 2), A=_tile(qp.A, K, 3),
        bl=_tile(qp.bl, K, 2), bu=_tile(qp.bu, K, 2), l=_tile(qp.l, K, 2),
        u=_tile(qp.u, K, 2))
    dK = _tile(d_col, K, 2)
    o2 = dataclasses.replace(opts, jitter=max(opts.jitter, 1e-3))
    if sos1 is not None and sos1[0] is not None:
        groups, active = sos1
        sos1K = (groups, active.repeat(K, 1))
    else:
        sos1K = sos1
    val, x, feas, _ = dive(qpK, dK, int_cols, o2, sos1=sos1K, sync=sync)
    val = torch.where(feas, val, _INF).reshape(K, S)
    x = x.reshape(K, S, n)
    k_best = torch.argmin(val, dim=0)                      # (S,)
    srange = torch.arange(S, device=val.device)
    best = val[k_best, srange]
    return best, x[k_best, srange], torch.isfinite(best)


def lns_repair(qp: BoxQP, d_col: Tensor, int_cols,
               x_inc_orig: Tensor, value0: Tensor, feas0: Tensor,
               opts: BnBOptions = BnBOptions(),
               rounds: int = 16, destroy_frac: float = 0.25,
               seed: int = 7, sos1=None, verbose: bool = False,
               sync=None):
    """Large-neighborhood polish of integral incumbents: per round,
    UNFIX a random per-scenario subset of SOS1 groups (the rest stay
    pinned at the incumbent) and re-dive warm, accepting per-scenario
    strict improvements only.  Deterministic via `seed`.  Returns
    (value, x_orig, feasible) or None when structureless."""
    if sos1 is None:
        sos1 = detect_sos1_groups(qp, d_col, int_cols, sync)
    groups, active = sos1
    if groups is None or rounds <= 0:
        return None
    dt, dev = qp.c.dtype, qp.c.device
    int_np = _np(_cols(int_cols, "cpu"))
    lo_root, hi_root = _root_bounds(qp, d_col, int_np)
    xi = np.round(_np(x_inc_orig)[:, int_np])
    best_val = np.array(_np(value0), np.float64)
    best_x = np.array(_np(x_inc_orig), np.float64)
    feas = np.array(_np(feas0), bool)
    groups_np = _np(groups)
    active_np = _np(active)
    G = groups_np.shape[0]
    S, nI = xi.shape
    membership = np.zeros((G, nI), bool)
    for g in range(G):
        membership[g, groups_np[g][groups_np[g] >= 0]] = True
    rng = np.random.default_rng(seed)
    warm_omega = warm_L = None   # captured from the first dive
    for r in range(rounds):
        if sync is None:
            draw = rng.random((S, G))
        else:   # this rank's rows of the whole axis's draw
            off, _, total = sync.rows
            draw = rng.random((total, G))[off:off + S]
        destroyed = (draw < destroy_frac) & active_np
        unfix = destroyed @ membership                     # (S, nI) bool
        cur = np.where(feas[:, None], xi, lo_root)         # infeasible:
        lo = np.where(unfix | ~feas[:, None], lo_root, cur)  # full re-dive
        hi = np.where(unfix | ~feas[:, None], hi_root, cur)
        val, x_new, f_new, warm = dive(
            qp, d_col, int_cols, opts,
            lo=torch.as_tensor(lo, dtype=dt, device=dev),
            hi=torch.as_tensor(hi, dtype=dt, device=dev),
            omega=warm_omega, Lnorm=warm_L, sos1=sos1, sync=sync)
        if warm_L is None:
            warm_omega, warm_L = warm[2], warm[3]
        val, x_new, f_new = _np(val), _np(x_new), _np(f_new)
        eps = 1e-6 * np.maximum(1.0, np.abs(best_val))
        better = f_new & (val < np.where(feas, best_val - eps, np.inf))
        if np.any(better):
            best_val = np.where(better, val, best_val)
            best_x = np.where(better[:, None], x_new, best_x)
            feas = feas | better
            xi = np.round(best_x[:, int_np])
        if (r + 1) % 4 == 0:
            global_toc(f"[lns] round {r + 1}: {best_val}", verbose)
    return (torch.as_tensor(np.where(feas, best_val, np.inf), dtype=dt,
                            device=dev),
            torch.as_tensor(best_x, dtype=dt, device=dev),
            torch.as_tensor(feas, device=dev))


def root_state(qp: BoxQP, d_col: Tensor, int_cols,
               opts: BnBOptions = BnBOptions(),
               incumbent: Tensor | None = None,
               x_inc: Tensor | None = None,
               warm: "tuple | None" = None) -> BnBState:
    """Root-node BnBState: the open pool seeded with the integer root
    box, everything else at its no-information sentinel.  warm:
    optional (x, y, omega, Lnorm); cold defaults otherwise."""
    S, n = qp.c.shape
    dt, dev = qp.c.dtype, qp.c.device
    int_np = _np(_cols(int_cols, "cpu"))
    nI = int(int_np.shape[0])
    P = opts.pool_size
    lo0, hi0 = _root_bounds(qp, d_col, int_np)
    if warm is None:
        x_w = torch.clamp(torch.zeros_like(qp.c), qp.l, qp.u)
        y_w = torch.zeros((S, qp.m), dtype=dt, device=dev)
        omega = torch.ones((S,), dtype=dt, device=dev)
        Lnorm = pdhg.estimate_norm(qp).to(dt)
    else:
        x_w, y_w, omega, Lnorm = warm
    pool_lo = torch.zeros((S, P, nI), dtype=dt, device=dev)
    pool_hi = torch.zeros((S, P, nI), dtype=dt, device=dev)
    pool_lo[:, 0, :] = torch.as_tensor(lo0, dtype=dt, device=dev)
    pool_hi[:, 0, :] = torch.as_tensor(hi0, dtype=dt, device=dev)
    pool_bound = torch.full((S, P), _INF, dtype=dt, device=dev)
    pool_bound[:, 0] = -_INF
    pool_active = torch.zeros((S, P), dtype=torch.bool, device=dev)
    pool_active[:, 0] = True

    def full(v, dtype=dt):
        return torch.full((S,), v, dtype=dtype, device=dev)

    return BnBState(
        pool_lo=pool_lo, pool_hi=pool_hi, pool_bound=pool_bound,
        pool_active=pool_active,
        pool_depth=torch.zeros((S, P), dtype=torch.int32, device=dev),
        incumbent=full(_INF) if incumbent is None else incumbent,
        x_inc=(torch.zeros((S, n), dtype=dt, device=dev) if x_inc is None
               else x_inc),
        fathom_floor=full(_INF), lost_bound=full(_INF),
        x_warm=x_w, y_warm=y_w, omega_warm=omega, Lnorm=Lnorm,
        outer=full(-_INF), done=full(False, torch.bool),
        nodes_solved=full(0, torch.int32),
    )


def solve_mip(qp: BoxQP, d_col: Tensor, int_cols,
              opts: BnBOptions = BnBOptions(),
              x_warm: Tensor | None = None, y_warm: Tensor | None = None,
              verbose: bool = False, sync=None) -> BnBResult:
    """Batched exact MIP solve: dive for an incumbent, then best-first
    branch-and-bound until every scenario's certified gap closes (or the
    round budget runs out — the bracket stays valid either way).

    qp:       scaled batched BoxQP ((S, n) fields; A may broadcast).
    d_col:    Ruiz column scaling ((n,) or (S, n)); x_orig = d_col * x.
    int_cols: indices of the integer columns (shared across the batch).
    """
    dt, dev = qp.c.dtype, qp.c.device
    int_cols = _cols(int_cols, dev)

    sos1 = detect_sos1_groups(qp, d_col, int_cols, sync)
    inc, x_inc, feas, warm = dive(qp, d_col, int_cols, opts,
                                  x_warm=x_warm, y_warm=y_warm, sos1=sos1,
                                  sync=sync)
    dive_x, dive_y, omega, Lnorm = warm
    if verbose and bool(feas.any()):
        global_toc(f"[bnb] dive incumbents: {_np(inc)}", True)
    if opts.pump_rounds > 0:
        p_val, p_x, p_feas = feasibility_pump(
            qp, d_col, int_cols, opts, rounds=opts.pump_rounds,
            x_warm=dive_x, y_warm=dive_y, omega=omega, Lnorm=Lnorm,
            sync=sync)
        inc, x_inc, feas = merge_incumbents(inc, x_inc, feas,
                                            p_val, p_x, p_feas)
        global_toc(f"[bnb] pump incumbents: {_np(p_val)}", verbose)

    rep = sos1_swap_repair(qp, d_col, int_cols, x_inc, feas, opts,
                           warm=(dive_x, dive_y, omega, Lnorm),
                           sos1=sos1, verbose=verbose, sync=sync)
    if rep is not None:
        inc, x_inc, feas = merge_incumbents(inc, x_inc, feas, *rep)
        global_toc(f"[bnb] swap-repaired incumbents: {_np(inc)}", verbose)

    st = root_state(qp, d_col, int_cols, opts,
                    incumbent=torch.where(feas, inc, _INF).to(dt),
                    x_inc=x_inc.to(dt),
                    warm=(dive_x, dive_y, omega, Lnorm))
    for r in range(opts.max_rounds):
        st = bnb_round(qp, d_col, int_cols, st, opts)
        if _all(sync, st.done):
            break
        if (r + 1) % 25 == 0:
            global_toc(f"[bnb] round {r + 1}: inc={_np(st.incumbent)} "
                       f"outer={_np(st.outer)}", verbose)

    # final polish: B&B rounds may have found incumbents the swap repair
    # has not seen yet
    rep = sos1_swap_repair(
        qp, d_col, int_cols, st.x_inc, torch.isfinite(st.incumbent), opts,
        warm=(st.x_warm, st.y_warm, st.omega_warm, st.Lnorm),
        sos1=sos1, verbose=verbose, sync=sync)
    if rep is not None:
        new_inc, new_x, _ = merge_incumbents(
            st.incumbent, st.x_inc, torch.isfinite(st.incumbent), *rep)
        st = dataclasses.replace(st, incumbent=new_inc, x_inc=new_x)

    # the loop's telemetry: this solve's nodes (counted per lane in
    # BnBState.nodes_solved) and closed lanes go into the process metrics
    # registry; inc, not set: each solve_mip adds its share to the
    # monotone process totals, as in the JAX package
    from mpisppy_tpu_torch.telemetry import metrics as _metrics
    _metrics.REGISTRY.inc("bnb_nodes_solved_total",
                          int(st.nodes_solved.sum()))
    _metrics.REGISTRY.inc("bnb_lanes_closed_total", int(st.done.sum()))

    inner = st.incumbent
    # a scenario that exhausted its pool with no incumbent and no open
    # nodes has outer = min(fathom_floor, lost): reported as is
    scale = torch.clamp(inner.abs(), min=1.0)
    gap = torch.where(torch.isfinite(inner), (inner - st.outer) / scale,
                      _INF)
    return BnBResult(x=st.x_inc, inner=inner, outer=st.outer, gap=gap,
                     feasible=torch.isfinite(inner),
                     nodes_solved=st.nodes_solved)
