###############################################################################
# Restarted PDHG (PDLP-style) for batched BoxQPs (port of
# mpisppy_tpu/ops/pdhg.py: box rows and second-order-cone blocks).
#
# The solver behind every cylinder: Chambolle-Pock primal-dual hybrid
# gradient with the exact prox of c'x + 1/2 q x^2 over [l, u], the dual
# prox of the row indicator via Moreau, adaptive restart-to-average
# (candidates scored every restart_period iterations, a restart fires on
# sufficient score decay or at a forced window cap), and an adaptive
# primal weight omega updated at restarts.
#
# Per-problem termination is a `done` mask, so the batch stays
# rectangular.  Each restart window is `restart_period` iterations, on
# the engine window_engine names: every batch with one dense shared A
# runs them in the hand-written window kernel on CUDA
# (ops/pdhg_window.py; its plain version on the CPU), and every other
# problem (a per-scenario dense A, as farmer's, or an ELL matrix, as
# uc's) runs the plain batched iteration below (_pdhg_iter) on whatever
# device it is on, as the JAX package runs it under XLA.
#
# The JAX package's while_loop over windows becomes a host loop here:
# solve() reads `all(done)` once per restart window (one device sync per
# window).  solve_fixed() has no early exit and never syncs.
###############################################################################
from __future__ import annotations

import dataclasses
import functools

import torch

from mpisppy_tpu_torch.ops import cones as cones_mod
from mpisppy_tpu_torch.ops import pdhg_window
from mpisppy_tpu_torch.ops.boxqp import (
    BoxQP, as_precision, infeasibility_certificate, kkt_residuals,
    shard_rows, unboundedness_certificate,
)
from mpisppy_tpu_torch.ops.sparse import EllMatrix
from mpisppy_tpu_torch.scengen.random import normal, prng_key
from mpisppy_tpu_torch.telemetry import counters as kcounters

Tensor = torch.Tensor

# Per-problem statuses (ref:mpisppy/spopt.py:76-96,194-231)
RUNNING = 0       # not terminated (hit max_iters => unconverged)
OPTIMAL = 1
INFEASIBLE = 2    # certified by a Farkas ray
UNBOUNDED = 3     # certified by a recession direction with c'd < 0

# the power iteration's start vector is normal(prng_key(POWER_SEED)),
# the JAX package's jax.random.normal(PRNGKey(7)) bit for bit
POWER_SEED = 7


@dataclasses.dataclass(frozen=True)
class PDHGOptions:
    """Solver options (frozen; see the JAX package for the rationale of
    each default)."""

    tol: float = 1e-6  # floored at 5*eps of the working dtype at solve time
    max_iters: int = 20_000
    # solve() runs at most this many iterations per capped chunk before
    # re-checking its budget on the host (0 disables the chunking)
    dispatch_cap: int = 60_000
    restart_period: int = 40   # candidate-check cadence (iterations)
    omega0: float = 1.0
    power_iters: int = 30
    omega_min: float = 1e-4
    omega_max: float = 1e4
    step_margin: float = 0.99  # tau*sigma*||A||^2 = step_margin^2 < 1
    restart_decay: float = 0.5  # restart on score <= decay * score@restart
    max_window: int = 16        # forced restart after this many periods
    detect_infeas: bool = False  # per-problem Farkas/recession certificates
    certificate_tol: float = 1e-4
    # arithmetic of the ITERATION matvecs inside the window kernel only
    # (ops/boxqp.py PRECISION_ALIASES); restart scoring and convergence
    # tests always run in f32.  None = f32.
    iter_precision: str | None = None
    # per-lane divergence guard: quarantine-reset lanes whose iterates
    # are non-finite or exceed guard_threshold, at most guard_max_resets
    # times, then freeze them done with status RUNNING
    lane_guard: bool = False
    guard_threshold: float = 1e12
    guard_max_resets: int = 3
    # kernel counters (telemetry/counters.py): per-lane iteration,
    # restart and omega-adaptation counts plus a small KKT-score ring,
    # folded in at each restart boundary by a few elementwise launches
    # (no kernel changes).  False leaves PDHGState.counters None and a
    # window's launches exactly those of a build without counters.
    telemetry: bool = False
    telemetry_ring: int = 8   # score samples kept per lane


@dataclasses.dataclass(frozen=True)
class PDHGState:
    x: Tensor        # (..., n) primal iterate
    y: Tensor        # (..., m) dual iterate
    x_sum: Tensor    # running window sums for restart-to-average
    y_sum: Tensor
    x_anchor: Tensor  # iterate at last restart (for omega adaptation)
    y_anchor: Tensor
    omega: Tensor    # (...,) primal weight
    Lnorm: Tensor    # (...,) ||A||_2 estimate
    k: int           # global iteration counter (host int: no sync)
    nwin: Tensor     # (...,) iterations since this problem's last restart
    restart_score: Tensor  # (...,) candidate score at last restart
    score: Tensor    # (...,) last max relative KKT residual
    done: Tensor     # (...,) bool
    status: Tensor   # (...,) int32 RUNNING/OPTIMAL/INFEASIBLE/UNBOUNDED
    guard_resets: Tensor  # (...,) int32 cumulative lane-guard quarantines
    # telemetry.counters.KernelCounters when opts.telemetry, else None
    counters: object = None


def _bshape(p: BoxQP):
    """Batch shape of a problem: () or (S,)."""
    return tuple(p.c.shape[:-1])


@functools.lru_cache(maxsize=8)
def _start_vector(shape: tuple) -> Tensor:
    """The power iteration's start vector on the CPU (cached by shape:
    the f32-exact draw costs ~0.5 s per million entries, and a wheel
    starts many solves of a few shapes)."""
    return normal(prng_key(POWER_SEED), shape)


def estimate_norm(p: BoxQP, iters: int = 30) -> Tensor:
    """Power iteration for ||A||_2, batch-aware, from the JAX package's
    random start vector (an all-ones start lies in null(A'A) for
    difference rows), drawn on the CPU and moved, so the card and the
    CPU start from the same vector.  Floored by the max row/column
    2-norms, both lower bounds on ||A||_2."""
    v = shard_rows(_start_vector, tuple(p.c.shape), p.rows).to(
        dtype=p.c.dtype, device=p.device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    lam = torch.ones(_bshape(p), dtype=p.c.dtype, device=p.device)
    if isinstance(p.A, Tensor) and p.A.ndim == 3:
        # a per-scenario A as products and sums, the order of the JAX
        # package's XLA dot on some CPUs; XLA's CPU reduction order
        # follows the host's vector ISA, so elsewhere farmer's estimate
        # differs from the JAX package's by an ulp (within 1e-7)
        def AtA(u):
            return (p.A * (p.A * u[..., None, :]).sum(-1)[..., None]).sum(-2)
    else:
        def AtA(u):
            return p.rmatvec(p.matvec(u))
    for _ in range(iters):
        w = AtA(v)
        nrm = torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True),
                          min=1e-30)
        v, lam = w / nrm, nrm[..., 0]
    if isinstance(p.A, EllMatrix):
        row_lb = torch.sqrt(p.A.row_sqnorms().amax(dim=-1))
        col_lb = torch.sqrt(p.A.col_sqnorms().amax(dim=-1))
    else:
        AA = p.A * p.A
        row_lb = torch.sqrt(AA.sum(dim=-1).amax(dim=-1))
        col_lb = torch.sqrt(AA.sum(dim=-2).amax(dim=-1))
    lb = torch.clamp(torch.maximum(row_lb, col_lb), min=1e-12)
    return torch.maximum(torch.sqrt(lam), lb)


def init_state(p: BoxQP, opts: PDHGOptions = PDHGOptions(),
               x0: Tensor | None = None,
               y0: Tensor | None = None,
               Lnorm: Tensor | None = None) -> PDHGState:
    """Cold state: x clipped zero, y zero, ||A|| by power iteration
    unless the caller gives its estimate (`Lnorm`)."""
    bs = _bshape(p)
    dt, dev = p.c.dtype, p.device
    if x0 is None:
        x0 = torch.clamp(torch.zeros_like(p.c), p.l, p.u)
    if y0 is None:
        y0 = torch.zeros(bs + (p.m,), dtype=dt, device=dev)
    if Lnorm is None:
        Lnorm = estimate_norm(p, opts.power_iters)
    L = torch.broadcast_to(Lnorm.to(dt), bs).clone()

    def full(v, dtype=dt):
        return torch.full(bs, v, dtype=dtype, device=dev)

    return PDHGState(
        x=x0, y=y0,
        x_sum=torch.zeros_like(x0), y_sum=torch.zeros_like(y0),
        x_anchor=x0, y_anchor=y0,
        omega=full(opts.omega0), Lnorm=L, k=0,
        nwin=full(0, torch.int32),
        restart_score=full(float("inf")), score=full(float("inf")),
        done=full(False, torch.bool), status=full(0, torch.int32),
        guard_resets=full(0, torch.int32),
        counters=_init_counters(bs, dt, dev, opts),
    )


def state_template(bs: tuple, n: int, m: int, dt,
                   opts: PDHGOptions) -> PDHGState:
    """init_state's shapes and dtypes without its work: every tensor on
    the meta device (no memory), counters as `opts` arm them — the
    checkpoint restore's template (utils/wxbarutils.py)."""
    bs = tuple(bs)

    def t(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    return PDHGState(
        x=t(bs + (n,)), y=t(bs + (m,)), x_sum=t(bs + (n,)),
        y_sum=t(bs + (m,)), x_anchor=t(bs + (n,)), y_anchor=t(bs + (m,)),
        omega=t(bs), Lnorm=t(bs), k=0, nwin=t(bs, torch.int32),
        restart_score=t(bs), score=t(bs), done=t(bs, torch.bool),
        status=t(bs, torch.int32), guard_resets=t(bs, torch.int32),
        counters=_init_counters(bs, dt, "meta", opts))


def _init_counters(bs, dt, dev, opts: PDHGOptions):
    if not opts.telemetry:
        return None
    return kcounters.init_counters(bs, dt, dev, ring_size=opts.telemetry_ring)


def _with_counters(st: PDHGState, opts: PDHGOptions) -> PDHGState:
    """A warm state built under telemetry-off options gets zeroed
    counters when these options turn them on (totals are per solve
    lineage from here)."""
    if opts.telemetry and st.counters is None:
        return dataclasses.replace(st, counters=_init_counters(
            tuple(st.omega.shape), st.x.dtype, st.x.device, opts))
    return st


def _pdhg_iter(p: BoxQP, st: PDHGState, tau: Tensor,
               sigma: Tensor) -> PDHGState:
    """One plain PDHG step (problems outside the window kernel's scope);
    frozen for problems already `done`.  Box rows take the two-sided
    clip; conic problems route through cones.dual_prox, which applies
    the Moreau second-order-cone projection blockwise on SOC rows."""
    t = tau[..., None]
    s = sigma[..., None]
    v = st.x - t * p.rmatvec(st.y)
    x1 = torch.clamp((v - t * p.c) / (1.0 + t * p.q), p.l, p.u)
    w = st.y + s * p.matvec(2.0 * x1 - st.x)
    if p.cones is None:
        y1 = w - s * torch.clamp(w / s, p.bl, p.bu)
    else:
        y1 = cones_mod.dual_prox(p.cones, w, s, p.bl, p.bu)
    keep = st.done[..., None]
    x1 = torch.where(keep, st.x, x1)
    y1 = torch.where(keep, st.y, y1)
    return dataclasses.replace(st, x=x1, y=y1, x_sum=st.x_sum + x1,
                               y_sum=st.y_sum + y1)


def _restart(p: BoxQP, st: PDHGState, opts: PDHGOptions) -> PDHGState:
    """Adaptive restart-to-average + omega adaptation + convergence
    check: the candidate is the better of the current iterate and the
    window average by relative KKT score; the restart fires per element
    on score decay to restart_decay of its last restart score, at the
    max_window cap, or on convergence."""
    navg = torch.clamp(st.nwin, min=1).to(st.x.dtype)[..., None]
    xa, ya = st.x_sum / navg, st.y_sum / navg

    rp_c, rd_c, rg_c = kkt_residuals(p, st.x, st.y)
    rp_a, rd_a, rg_a = kkt_residuals(p, xa, ya)
    score_c = torch.maximum(torch.maximum(rp_c, rd_c), rg_c)
    score_a = torch.maximum(torch.maximum(rp_a, rd_a), rg_a)

    take_avg = (score_a < score_c)[..., None]
    xr = torch.where(take_avg, xa, st.x)
    yr = torch.where(take_avg, ya, st.y)
    score = torch.minimum(score_a, score_c)

    # dtype-aware tolerance floor (5*eps, ~6e-7 in f32)
    tol = max(opts.tol, 5.0 * torch.finfo(st.x.dtype).eps)
    newly_done = score <= tol

    fire = (score <= opts.restart_decay * st.restart_score) \
        | (st.nwin >= opts.max_window * opts.restart_period) \
        | newly_done

    # primal-weight adaptation (theta = 0.5 log-space smoothing) at
    # restarts: omega ~ |dx|/|dy| balances per-window travel
    dx = torch.linalg.vector_norm(xr - st.x_anchor, dim=-1)
    dy = torch.linalg.vector_norm(yr - st.y_anchor, dim=-1)
    valid = fire & (dx > 1e-12) & (dy > 1e-12)
    ratio = torch.where(valid, dx / torch.clamp(dy, min=1e-30),
                        torch.ones_like(dx))
    omega_new = torch.exp(0.5 * torch.log(ratio) + 0.5 * torch.log(st.omega))
    omega = torch.clamp(torch.where(valid, omega_new, st.omega),
                        opts.omega_min, opts.omega_max)

    status = torch.where(~st.done & newly_done,
                         torch.full_like(st.status, OPTIMAL), st.status)
    if opts.detect_infeas:
        # approximate rays from the per-window displacement, gated on
        # being far from converged (PDLP's detection recipe)
        ctol = opts.certificate_tol
        far = score > max(1e-3, 10.0 * tol)
        infeas = far & (infeasibility_certificate(p, yr - st.y_anchor, ctol)
                        | infeasibility_certificate(p, yr, ctol))
        unbd = far & unboundedness_certificate(p, xr - st.x_anchor, ctol)
        status = torch.where(~st.done & ~newly_done & infeas,
                             torch.full_like(status, INFEASIBLE), status)
        status = torch.where((status == RUNNING) & unbd,
                             torch.full_like(status, UNBOUNDED), status)
        newly_done = newly_done | ((status != RUNNING) & ~st.done)

    act = fire & ~st.done           # restart these elements
    actx = act[..., None]
    zx, zy = torch.zeros_like(st.x_sum), torch.zeros_like(st.y_sum)
    return dataclasses.replace(
        st,
        x=torch.where(actx, xr, st.x),
        y=torch.where(actx, yr, st.y),
        x_sum=torch.where(actx, zx, st.x_sum),
        y_sum=torch.where(actx, zy, st.y_sum),
        x_anchor=torch.where(actx, xr, st.x_anchor),
        y_anchor=torch.where(actx, yr, st.y_anchor),
        omega=torch.where(st.done, st.omega, omega),
        nwin=torch.where(act, torch.zeros_like(st.nwin), st.nwin),
        restart_score=torch.where(act, score, st.restart_score),
        score=torch.where(st.done, st.score, score),
        done=st.done | newly_done,
        status=status,
    )


def _lane_guard(p: BoxQP, st: PDHGState, opts: PDHGOptions) -> PDHGState:
    """Quarantine-reset diverged lanes: non-finite or above
    guard_threshold.  Bad lanes restart from the clipped origin with
    halved omega, up to guard_max_resets times; past the budget a lane
    is frozen done with status RUNNING (never certifies).  Every bad
    lane's iterates are scrubbed, so a frozen lane never feeds NaN
    downstream."""
    mag = torch.maximum(st.x.abs().amax(dim=-1), st.y.abs().amax(dim=-1))
    bad = ~st.done & (~torch.isfinite(mag) | (mag > opts.guard_threshold))
    give_up = bad & (st.guard_resets >= opts.guard_max_resets)
    rx = bad[..., None]
    x0 = torch.clamp(torch.zeros_like(st.x), p.l, p.u)
    zx, zy = torch.zeros_like(st.x), torch.zeros_like(st.y)
    half = torch.where(torch.isfinite(st.omega), 0.5 * st.omega,
                       torch.full_like(st.omega, opts.omega0))
    return dataclasses.replace(
        st,
        x=torch.where(rx, x0, st.x),
        y=torch.where(rx, zy, st.y),
        x_sum=torch.where(rx, zx, st.x_sum),
        y_sum=torch.where(rx, zy, st.y_sum),
        x_anchor=torch.where(rx, x0, st.x_anchor),
        y_anchor=torch.where(rx, zy, st.y_anchor),
        omega=torch.where(bad, torch.clamp(half, min=opts.omega_min),
                          st.omega),
        nwin=torch.where(bad, torch.zeros_like(st.nwin), st.nwin),
        restart_score=torch.where(bad, torch.full_like(st.score, float("inf")),
                                  st.restart_score),
        score=torch.where(bad, torch.full_like(st.score, float("inf")),
                          st.score),
        guard_resets=st.guard_resets + bad.to(torch.int32),
        done=st.done | give_up,
    )


def window_engine(p: BoxQP, device_type: str) -> str:
    """Which engine runs a restart window of `p` (the JAX package's
    rule: only a batch with one dense shared A reaches the Pallas
    window; everything else runs the plain iteration under XLA).

    "kernel": a (S,)-batched problem with one dense shared (m, n) A —
    the window kernel on CUDA tensors, its plain version on CPU ones.
    "plain": any other A (a per-scenario dense (S, m, n), an ELL matrix,
    or an unbatched problem) — the plain batched iteration (_pdhg_iter)
    on whatever device the tensors are on.  A structural rule, fixed
    before any launch: a kernel batch whose launch fails raises, it
    never takes the plain path."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"window_engine: unsupported device {device_type!r}")
    return "kernel" if pdhg_window.supported(p) else "plain"


def _window(p: BoxQP, st: PDHGState, opts: PDHGOptions) -> PDHGState:
    """One restart window: restart_period iterations, then _restart
    (and the lane guard when enabled), on the engine window_engine
    names.  The plain iteration runs its matvecs in f32 (iter_precision
    selects the kernel's arithmetic only)."""
    tau = opts.step_margin * st.omega / st.Lnorm
    sigma = opts.step_margin / (st.omega * st.Lnorm)
    pre_done, pre_omega = st.done, st.omega
    if window_engine(p, st.x.device.type) == "kernel":
        x, y, xs, ys = pdhg_window.run_window(
            p, st.x, st.y, st.x_sum, st.y_sum, tau, sigma, st.done,
            opts.restart_period, precision=opts.iter_precision)
        st = dataclasses.replace(st, x=x, y=y, x_sum=xs, y_sum=ys)
    else:
        as_precision(opts.iter_precision)  # validate the alias
        for _ in range(opts.restart_period):
            st = _pdhg_iter(p, st, tau, sigma)
    st = dataclasses.replace(st, nwin=st.nwin + opts.restart_period)
    st = _restart(p, st, opts)
    if opts.telemetry:
        # the restart boundary is the observation point: nwin was just
        # incremented by restart_period, so a zero here means _restart
        # fired for that lane.  Recorded BEFORE the lane guard (a
        # quarantine also clears nwin and counts in guard_resets).
        st = dataclasses.replace(st, counters=kcounters.record_window(
            st.counters, active=~pre_done, restarted=st.nwin == 0,
            omega_moved=st.omega != pre_omega, score=st.score,
            period=opts.restart_period))
    if opts.lane_guard:
        st = _lane_guard(p, st, opts)
    return dataclasses.replace(st, k=st.k + opts.restart_period)


def will_chunk(opts: PDHGOptions) -> bool:
    """True when solve() with these options runs in capped chunks."""
    return 0 < opts.dispatch_cap < opts.max_iters


def _reset_bookkeeping(state: PDHGState, reset_k: bool,
                       reset_score: bool) -> PDHGState:
    bs = state.omega.shape
    inf = torch.full(bs, float("inf"), dtype=state.x.dtype,
                     device=state.x.device)
    kw = dict(
        x_sum=torch.zeros_like(state.x), y_sum=torch.zeros_like(state.y),
        x_anchor=state.x, y_anchor=state.y,
        nwin=torch.zeros_like(state.nwin), restart_score=inf,
        done=torch.zeros_like(state.done),
        status=torch.zeros_like(state.status))
    if reset_k:
        kw["k"] = 0
    if reset_score:
        kw["score"] = inf.clone()
    return dataclasses.replace(state, **kw)


def solve(p: BoxQP, opts: PDHGOptions = PDHGOptions(),
          state: PDHGState | None = None) -> PDHGState:
    """Solve to tolerance (batch-aware).  A warm `state` keeps its
    iterates and step machinery; bookkeeping is reset.  Budgets above
    dispatch_cap run as capped chunks (_dispatch_capped), re-checked on
    the host between chunks."""
    if state is None:
        st = init_state(p, opts)
    else:
        st = _with_counters(_reset_bookkeeping(
            state, reset_k=True, reset_score=True), opts)
    if will_chunk(opts):
        while True:
            st = _dispatch_capped(p, opts, st)
            if st.k >= opts.max_iters or bool(torch.all(st.done)):
                return st
    return _solve_loop(p, opts, st, opts.max_iters)


def _solve_loop(p: BoxQP, opts: PDHGOptions, st: PDHGState,
                k_stop: int) -> PDHGState:
    """Windows until k_stop or every problem is done.  The `all(done)`
    test reads the device once per window (one sync per window)."""
    while st.k < min(k_stop, opts.max_iters) and not bool(torch.all(st.done)):
        st = _window(p, st, opts)
    return st


def _dispatch_capped(p, opts, st):
    """One capped chunk: at most dispatch_cap more iterations past the
    entry count st.k (a seam tests patch to observe the chunking)."""
    return _solve_loop(p, opts, st, st.k + opts.dispatch_cap)


def solve_fixed(p: BoxQP, n_windows: int, opts: PDHGOptions,
                state: PDHGState) -> PDHGState:
    """Fixed budget: n_windows restart windows, no early exit and no
    device sync — the inner solver of the PH hot loops (inexact
    warm-started subproblem solves)."""
    st = _with_counters(_reset_bookkeeping(
        state, reset_k=False, reset_score=False), opts)
    for _ in range(n_windows):
        st = _window(p, st, opts)
    return st
