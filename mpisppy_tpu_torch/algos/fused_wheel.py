###############################################################################
# Fused hub-and-spoke wheel step (port of mpisppy_tpu/algos/fused_wheel.py).
#
# On one device every cylinder shares one queue, so the spokes' bound
# work rides inside the hub's iteration instead of running beside it:
# the Lagrangian bound is the SAME subproblem solver with W frozen and no
# prox, and each x̂ recourse evaluation (round(x̄), the slammed
# candidate, one shuffled scenario's own nonants) is the SAME solver with
# the nonant box collapsed — each a fixed small budget of restart windows
# with WARM state carried across iterations.  Bounds are gated by the same
# certificates as standalone spokes (dual residual for the Lagrangian,
# primal-residual feasibility plus compensation tightness for x̂).
#
# Port notes: the JAX optimization_barrier fences between planes only
# managed TPU VMEM and are dropped; the straggler tail's lax.cond becomes
# one host read of `needed` per exchange; the packed scalars are copied
# to pinned host memory as soon as they are computed, so the pipelined
# read of the previous iteration's scalars never waits for the current
# step.  The async wheel's exchange plane (ExchangePlane, plane_of,
# ph_stale_step) lives here too, beside the planes it feeds.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch import dispatch as _dispatch
from mpisppy_tpu_torch.algos import aph as aph_mod
from mpisppy_tpu_torch.algos import lagrangian as lag_mod
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.algos import xhat as xhat_mod
from mpisppy_tpu_torch.core.batch import ScenarioBatch, concretize
from mpisppy_tpu_torch.ops import boxqp, pdhg
from mpisppy_tpu_torch.ops import sparse as sparse_mod
from mpisppy_tpu_torch.telemetry import counters as kcounters
from mpisppy_tpu_torch.utils.host_copy import HostCopy

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FusedWheelOptions:
    """Per-iteration budgets for the fused spoke planes (a window is
    `restart_period` PDHG iterations).  See the JAX package for the
    measurements behind each default."""

    lag_windows: int = 8
    xhat_windows: int = 4
    slam_windows: int = 0        # 0 = slam plane disabled
    slam_sense_max: bool = True  # slam to the scenario max (else min)
    shuffle_windows: int = 0     # 0 = shuffle plane disabled
    # run the spoke planes only every spoke_period-th iteration
    spoke_period: int = 1
    # dispatch each plane as its own step instead of one fused program;
    # None = split at >= 512 scenarios
    split_dispatch: bool | None = None
    # adaptive {full, lean} budgets driven by certification streaks
    # (split mode only)
    adapt_budgets: bool = True
    adapt_lag_budget: bool = False
    lean_lag_windows: int = 2
    lean_xhat_windows: int = 1
    lean_slam_windows: int = 1
    lean_shuffle_windows: int = 1
    adapt_stall: int = 3
    # the x̄ plane's candidate stays frozen until it lands, is certified
    # dead, or xhat_give_up exchanges pass (split mode)
    xhat_give_up: int = 25
    # straggler tail: the xhat_tail_k worst-residual scenarios get
    # xhat_tail_windows extra windows at the tier-2 rescue profile
    xhat_tail_k: int = 64
    xhat_tail_windows: int = 12
    lag_pdhg: pdhg.PDHGOptions = pdhg.PDHGOptions(
        tol=1e-6, restart_period=40)
    xhat_pdhg: pdhg.PDHGOptions = pdhg.PDHGOptions(
        tol=1e-6, omega0=0.1, restart_period=80)
    xhat_feas_tol: float = 1e-3
    # max first-order infeasibility compensation (relative to the value)
    # a published inner bound may carry — see _eval_step
    xhat_comp_tol: float = 2e-3


@dataclasses.dataclass(frozen=True)
class FusedWheelState:
    ph: ph_mod.PHState
    lag_solver: pdhg.PDHGState   # warm iterates for L(W)
    lag_bound: Tensor            # () latest E[dual] at W
    lag_certified: Tensor        # () bool: dual residuals cleared tol
    xhat_solver: pdhg.PDHGState  # warm iterates for the recourse eval
    xhat_cand: Tensor            # (num_nodes, N) candidate evaluated
    xhat_value: Tensor           # () E[f(xhat)]; +inf unless feasible
    xhat_feasible: Tensor        # () bool
    xhat_dead: Tensor            # () bool: some scenario CERTIFIED
    #                              infeasible/unbounded at this candidate
    slam_solver: pdhg.PDHGState  # warm iterates for the slam candidate
    slam_cand: Tensor            # (N,) slammed candidate
    slam_value: Tensor           # ()
    slam_feasible: Tensor        # () bool
    shuf_solver: pdhg.PDHGState  # warm iterates for the shuffle candidate
    shuf_cand: Tensor            # (N,) candidate (one scenario's nonants)
    shuf_value: Tensor           # ()
    shuf_feasible: Tensor        # () bool
    # (10,) f32, layout SCALAR_KEYS: every per-iteration host decision
    # packed into one tensor, so the hub pays one transfer per iteration
    scalars: Tensor


def _lag_step(batch: ScenarioBatch, W: Tensor, solver: pdhg.PDHGState,
              wopts: FusedWheelOptions, windows: int | None = None):
    """Advance the Lagrangian solve a fixed budget and certify the bound
    (algos.lagrangian.lagrangian_bound, truncated)."""
    qp = lag_mod._lagrangian_qp(batch, W)
    n_win = wopts.lag_windows if windows is None else windows
    st = pdhg.solve_fixed(qp, n_win, wopts.lag_pdhg, solver)
    dual = boxqp.dual_objective(qp, st.x, st.y)
    _, rd, _ = boxqp.kkt_residuals(qp, st.x, st.y)
    tol = max(wopts.lag_pdhg.tol, 5.0 * torch.finfo(st.x.dtype).eps)
    certified = batch.all_real(rd <= 10.0 * tol)
    return st, batch.expectation(dual), certified


def _scen_leaf(a, S: int) -> bool:
    return isinstance(a, torch.Tensor) and a.ndim > 0 and a.shape[0] == S


def _map_scen(st, S: int, fn, sub=None):
    """fn(leaf) — fn(leaf, sub's leaf) when `sub` is given — on every
    (S, ...) tensor field of a PDHGState and of its kernel counters;
    scalars and host ints stay (the JAX package's tree_map over the
    state's leaves)."""
    kw = {}
    for f in dataclasses.fields(st):
        a = getattr(st, f.name)
        b = None if sub is None else getattr(sub, f.name)
        if dataclasses.is_dataclass(a):
            kw[f.name] = _map_scen(a, S, fn, b)
        elif _scen_leaf(a, S):
            kw[f.name] = fn(a) if sub is None else fn(a, b)
    return dataclasses.replace(st, **kw)


def _gather_scen(st: pdhg.PDHGState, idx: Tensor, S: int) -> pdhg.PDHGState:
    """Index the leading scenario axis of every (S, ...) field of a
    PDHGState (its counters' too); do NOT use on a BoxQP — see
    _gather_qp."""
    return _map_scen(st, S, lambda a: a[idx])


def _gather_qp(qp: boxqp.BoxQP, idx: Tensor) -> boxqp.BoxQP:
    """Scenario-gather a BoxQP by FIELD LAYOUT, not dim-size guessing: a
    shared (m, n) A with m == S must never be gathered by scenario.  In
    an EllMatrix only a batched vals (S, m, k) is gathered; cols is an
    (m, k) pattern, never scenario-indexed."""
    def vec(a):       # c/q/l/u/bl/bu: (S, k) batched or (k,) shared
        return a[idx] if a.ndim == 2 else a

    A = qp.A
    if isinstance(A, sparse_mod.EllMatrix):
        if A.vals.ndim == 3:
            A = A.with_vals(A.vals[idx])
    elif A.ndim == 3:
        A = A[idx]
    return dataclasses.replace(
        qp, c=vec(qp.c), q=vec(qp.q), l=vec(qp.l), u=vec(qp.u),
        bl=vec(qp.bl), bu=vec(qp.bu), A=A)


def _scatter_scen(st: pdhg.PDHGState, sub: pdhg.PDHGState, idx: Tensor,
                  S: int) -> pdhg.PDHGState:
    """Write a gathered sub-state back into the (S, ...) fields."""
    return _map_scen(st, S, lambda a, b: a.index_copy(0, idx, b), sub)


def _tail_rescue(qp: boxqp.BoxQP, st: pdhg.PDHGState, rp: Tensor,
                 real: Tensor, wopts: FusedWheelOptions,
                 feas_tol: float, batch=None) -> pdhg.PDHGState:
    """In-loop straggler sub-solve: the top-k worst-residual scenarios
    get xhat_tail_windows extra windows at the tier-2 rescue profile on
    a gathered sub-batch, state scattered back.  k is capped at S/8 and
    quantized down the bucket ladder: the configured dispatch
    scheduler's when one exists (--dispatch-bucket-growth governs both
    the MIP megabatches and these gathers), else the default.  The sub-solve runs only while
    some real scenario misses the publication gate: `needed` is read on
    the host, one device sync per exchange.  On a batch sharded over
    several ranks, S, k and the top-k are those of the WHOLE axis (an
    all-gather of the masked residuals), so every rank takes the same
    decision; each rank re-solves the chosen scenarios it holds."""
    S = st.omega.shape[0]
    masked = torch.where(real, rp, -1.0)
    mesh = getattr(batch, "mesh", None)
    sharded = mesh is not None and getattr(mesh, "world", 1) > 1
    if sharded:
        masked = batch.scen_gather(masked)
    k = min(wopts.xhat_tail_k, max(8, masked.shape[0] // 8),
            masked.shape[0])
    if k > 0:
        sched = _dispatch.get_scheduler(create=False)
        ladder = sched.ladder if sched is not None \
            else _dispatch.default_ladder()
        k = min(ladder.bucket_floor(k), masked.shape[0])
    if k <= 0 or wopts.xhat_tail_windows <= 0:
        return st
    if not bool(torch.any(masked > feas_tol)):
        return st
    _, idx = torch.topk(masked, k)
    if sharded:
        off = batch.scen_offset
        idx = idx[(idx >= off) & (idx < off + S)] - off
        if idx.numel() == 0:
            return st
    sub_qp = _gather_qp(qp, idx)
    sub_st = _gather_scen(st, idx, S)
    topts = dataclasses.replace(
        wopts.xhat_pdhg, omega0=0.03, restart_period=160)
    sub_st = dataclasses.replace(
        sub_st, omega=torch.full_like(sub_st.omega, topts.omega0))
    sub_st = pdhg.solve_fixed(sub_qp, wopts.xhat_tail_windows, topts,
                              sub_st)
    return _scatter_scen(st, sub_st, idx, S)


def _eval_step(batch: ScenarioBatch, cand: Tensor,
               solver: pdhg.PDHGState, windows: int,
               wopts: FusedWheelOptions, tail: bool = False):
    """Advance the recourse evaluation of a fixed candidate a fixed
    budget, warm from `solver` clipped into the new fixed box (the
    frozen-lane trick of the window kernel needs box-feasible x).  The
    value counts only when EVERY real scenario's primal residual clears
    xhat_feas_tol, and it is COMPENSATED for residual infeasibility by
    COMP_SAFETY * E[sum_i |y_i| viol_i]; a compensation above
    xhat_comp_tol of the value keeps it unpublished."""
    qp = batch.with_fixed_nonants(cand)
    st = dataclasses.replace(solver, x=torch.clamp(solver.x, qp.l, qp.u))
    # detect_infeas: a candidate that leaves some scenario without
    # feasible recourse gets a Farkas certificate (`dead`)
    popts = dataclasses.replace(wopts.xhat_pdhg, detect_infeas=True)
    st = pdhg.solve_fixed(qp, windows, popts, st)
    real = batch.p > 0.0
    if tail:
        rp0, _, _ = boxqp.kkt_residuals(qp, st.x, st.y)
        st = _tail_rescue(qp, st, rp0, real, wopts, wopts.xhat_feas_tol,
                          batch)
    obj = torch.sum(qp.c * st.x + 0.5 * qp.q * st.x * st.x, dim=-1)
    viol = boxqp.primal_residual(qp, st.x)
    comp = xhat_mod.COMP_SAFETY * torch.sum(st.y.abs() * viol, dim=-1)
    obj = obj + comp
    rp, _, _ = boxqp.kkt_residuals(qp, st.x, st.y)
    bad_status = (st.status == pdhg.INFEASIBLE) \
        | (st.status == pdhg.UNBOUNDED)
    ok = (rp <= wopts.xhat_feas_tol) & ~bad_status
    feas = batch.all_real(ok)
    dead = batch.any_real(bad_status)
    inf = torch.full_like(obj[0], float("inf"))
    value = torch.where(feas, batch.expectation(obj), inf)
    ecomp = batch.expectation(comp)
    tight = ecomp <= wopts.xhat_comp_tol * torch.clamp(value.abs(), min=1.0)
    feas = feas & tight
    value = torch.where(feas, value, inf)
    return st, value, feas, dead


def fused_iter0(batch: ScenarioBatch, rho: Tensor, opts: ph_mod.PHOptions,
                wopts: FusedWheelOptions):
    """PH Iter0 plus spoke-plane state init: both plane solvers warm
    from the iter0 iterates (same A, so Lnorm/omega carry)."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    phst, tb, cert = ph_mod.ph_iter0(batch, rho, opts)
    solver = phst.solver
    dt, dev = batch.qp.c.dtype, batch.device
    if solver.counters is not None:
        # the planes warm-start from the hub's iter0 ITERATES, but their
        # kernel counters start at zero (copying the hub's iter0 totals
        # would count iter0 again under every plane's label)
        solver = dataclasses.replace(solver, counters=kcounters.init_counters(
            tuple(solver.omega.shape), dt, dev,
            ring_size=solver.counters.ring.shape[-1]))
    xhat_solver = dataclasses.replace(
        solver, omega=torch.full_like(solver.omega, wopts.xhat_pdhg.omega0))

    def scalar(v, dtype=dt):
        return torch.tensor(v, dtype=dtype, device=dev)

    st = FusedWheelState(
        ph=phst,
        lag_solver=solver,
        lag_bound=scalar(float("-inf")),
        lag_certified=scalar(False, torch.bool),
        xhat_solver=xhat_solver,
        xhat_cand=torch.zeros((batch.tree.num_nodes, batch.num_nonants),
                              dtype=dt, device=dev),
        xhat_value=scalar(float("inf")),
        xhat_feasible=scalar(False, torch.bool),
        xhat_dead=scalar(False, torch.bool),
        slam_solver=xhat_solver,
        slam_cand=torch.zeros((batch.num_nonants,), dtype=dt, device=dev),
        slam_value=scalar(float("inf")),
        slam_feasible=scalar(False, torch.bool),
        shuf_solver=xhat_solver,
        shuf_cand=torch.zeros((batch.num_nonants,), dtype=dt, device=dev),
        shuf_value=scalar(float("inf")),
        shuf_feasible=scalar(False, torch.bool),
        scalars=torch.zeros((len(SCALAR_KEYS),), dtype=dt, device=dev),
    )
    return dataclasses.replace(st, scalars=_pack_scalars(st)), tb, cert


def fused_state_template(batch: ScenarioBatch, opts: ph_mod.PHOptions,
                         wopts: FusedWheelOptions) -> FusedWheelState:
    """fused_iter0's state as shapes and dtypes (meta-device tensors, no
    solve): every plane solver has the hub solver's template, as
    fused_iter0 warm-starts them from it."""
    phst = ph_mod.ph_state_template(batch, opts)
    dt = batch.qp.c.dtype
    nodes, N = batch.tree.num_nodes, batch.num_nonants

    def t(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    b = torch.bool
    return FusedWheelState(
        ph=phst, lag_solver=phst.solver, lag_bound=t(),
        lag_certified=t(dtype=b), xhat_solver=phst.solver,
        xhat_cand=t(nodes, N), xhat_value=t(), xhat_feasible=t(dtype=b),
        xhat_dead=t(dtype=b), slam_solver=phst.solver, slam_cand=t(N),
        slam_value=t(), slam_feasible=t(dtype=b), shuf_solver=phst.solver,
        shuf_cand=t(N), shuf_value=t(), shuf_feasible=t(dtype=b),
        scalars=t(len(SCALAR_KEYS)))


SCALAR_KEYS = ("conv", "lag_bound", "lag_certified", "xhat_value",
               "xhat_feasible", "xhat_dead", "slam_value",
               "slam_feasible", "shuf_value", "shuf_feasible")

# How many exchanges the pipelined scalar cache lags the dispatched
# iterate (FusedPH._cache_scalars reads the PREVIOUS iteration's packed
# scalars, which themselves describe the step before it).  Every host
# decision that attributes cached flags to a candidate must wait this
# many evaluations (_next_xhat_cand's flags_fresh).
SCALAR_PIPELINE_DEPTH = 2


def _pack_scalars(st: FusedWheelState) -> Tensor:
    dt = st.ph.conv.dtype
    return torch.stack([st.ph.conv.to(dt)] + [
        getattr(st, key).to(dt) for key in SCALAR_KEYS[1:]])


def fused_iterk(batch: ScenarioBatch, st: FusedWheelState,
                opts: ph_mod.PHOptions, wopts: FusedWheelOptions,
                shuf_id: int = 0) -> FusedWheelState:
    """One wheel iteration as one step: hub PH step, then the Lagrangian
    bound at the fresh W and the recourse values at the fresh candidates
    (round(x̄), slam, the shuffled scenario `shuf_id`'s own nonants),
    each a fixed warm budget."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    phst = ph_mod.ph_iterk(batch, st.ph, opts)
    out = dataclasses.replace(st, ph=phst)
    if wopts.lag_windows > 0:
        lag_solver, lag_bound, lag_cert = _lag_step(
            batch, phst.W, st.lag_solver, wopts)
        out = dataclasses.replace(out, lag_solver=lag_solver,
                                  lag_bound=lag_bound,
                                  lag_certified=lag_cert)
    if wopts.xhat_windows > 0:
        cand = xhat_mod.round_integers(batch, phst.xbar_nodes)
        xs, value, feas, dead = _eval_step(batch, cand, st.xhat_solver,
                                           wopts.xhat_windows, wopts,
                                           tail=True)
        out = dataclasses.replace(out, xhat_solver=xs, xhat_cand=cand,
                                  xhat_value=value, xhat_feasible=feas,
                                  xhat_dead=dead)
    if wopts.slam_windows > 0:
        ss, scand, svalue, sfeas = _slam_step(
            batch, phst.solver.x, st.slam_solver, wopts,
            wopts.slam_windows, wopts.slam_sense_max)
        out = dataclasses.replace(out, slam_solver=ss, slam_cand=scand,
                                  slam_value=svalue, slam_feasible=sfeas)
    if wopts.shuffle_windows > 0:
        # one rotating candidate per iteration (the host supplies the
        # scenario from its seed-42 order)
        fs, fcand, fvalue, ffeas = _shuf_step(
            batch, phst.solver.x, st.shuf_solver, shuf_id, wopts,
            wopts.shuffle_windows)
        out = dataclasses.replace(out, shuf_solver=fs, shuf_cand=fcand,
                                  shuf_value=fvalue, shuf_feasible=ffeas)
    return dataclasses.replace(out, scalars=_pack_scalars(out))


def _slam_step(batch, x, solver, wopts, windows, sense_max):
    """Slam every nonant to its across-scenario max (min) and advance
    that candidate's recourse evaluation a fixed warm budget."""
    scand = xhat_mod.slam_candidate(batch, batch.nonants(x), sense_max)
    st, value, feas, _ = _eval_step(batch, scand, solver, windows, wopts)
    return st, scand, value, feas


def _shuf_step(batch, x, solver, sid, wopts, windows):
    """Scenario `sid`'s own nonants (integers rounded) as the candidate,
    its recourse evaluation advanced a fixed warm budget."""
    fcand = xhat_mod.round_integers(batch,
                                    batch.scen_row(batch.nonants(x), sid))
    st, value, feas, _ = _eval_step(batch, fcand, solver, windows, wopts)
    return st, fcand, value, feas


# --- async exchange plane ------------------------------------------------
# One slot of the double-buffered host<->device exchange plane: the
# W/x̄/iterate view the spoke planes and the stale-prox hub step read at
# iteration k while the host completes the exchange for an earlier
# iteration.  Slots hold REFERENCES: no step writes these tensors in
# place (the window wrapper returns fresh tensors, _tail_rescue's
# index_copy and the lane guard's where are out of place, extensions
# rebind the state instead of mutating it, and FaultPlan.corrupt_lanes
# clones), so a plane write is a reference swap, never a copy, and the
# ring costs no memory beyond the generations it keeps alive.

@dataclasses.dataclass(frozen=True)
class ExchangePlane:
    W: Tensor           # (S, N) duals at the plane's generation
    xbar: Tensor        # (S, N) per-scenario view of node averages
    xbar_nodes: Tensor  # (num_nodes, N)
    x: Tensor           # (S, n) full primal iterates (slam/shuf inputs)


def plane_of(phst: ph_mod.PHState) -> ExchangePlane:
    """The exchange-plane view of one PH state generation."""
    return ExchangePlane(W=phst.W, xbar=phst.xbar,
                         xbar_nodes=phst.xbar_nodes, x=phst.solver.x)


def ph_stale_step(batch: ScenarioBatch, st: ph_mod.PHState,
                  plane: ExchangePlane, opts: ph_mod.PHOptions,
                  nu: float = 1.0, gamma: float = 1.0,
                  theta_floor: float = 0.05):
    """One theta-damped PH hub step against a (possibly stale) exchange
    plane.  The subproblem proxes around the PLANE's x̄ instead of the
    state's freshest average; the multiplier update is damped by the APH
    projective step length (algos/aph.projective_theta):

        W_new = W + theta * rho * (x_new - x̄_new),  theta in [floor, 1]

    At plane == the previous iteration's output and theta == 1 this is
    exactly ph_iterk, so staleness 1 deviates from the synchronous
    trajectory only by the damping.  Returns (new_state, theta); theta
    is a device scalar."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    smooth_p = opts.smooth_p if opts.smoothed else 0.0
    qp_eff = ph_mod._prox_qp(batch, st.W, plane.xbar, st.z, st.rho,
                             smooth_p)
    solver = pdhg.solve_fixed(qp_eff, opts.subproblem_windows, opts.pdhg,
                              st.solver)
    st2 = dataclasses.replace(st, solver=solver)
    x_non, xbar, xbar_nodes, xsqbar, W_full, z, conv = ph_mod._xbar_w_conv(
        batch, st2, opts.smooth_beta, opts.smoothed, opts.compute_xsqbar)
    theta = aph_mod.projective_theta(batch, x_non, xbar, st.W, plane.xbar,
                                     plane.W, st.rho, nu, gamma)
    # floor: near convergence phi -> 0 would freeze the duals; a small
    # floor keeps the (already tiny) PH update flowing
    theta = torch.clamp(theta, min=theta_floor)
    # W_full is st.W + rho*(x - xbar) (masked for var_prob batches), so
    # blending recovers the damped update exactly
    W = st.W + theta * (W_full - st.W)
    out = dataclasses.replace(st2, W=W, z=z, xbar=xbar,
                              xbar_nodes=xbar_nodes, xsqbar=xsqbar,
                              conv=conv)
    return out, theta


# --- split-dispatch planes: each plane as its own step ------------------
# Each plane draws a VirtualBatch's data at its own entry (concretize),
# as the JAX package's jitted planes do; _round_xbar reads only
# integer_slot, which a VirtualBatch holds, so it draws nothing.
def lag_plane(batch, W, solver, wopts, windows):
    return _lag_step(concretize(batch), W, solver, wopts, windows)


def _round_xbar(batch, xbar_nodes, mode="nearest"):
    return xhat_mod.round_integers(batch, xbar_nodes, mode)


def xhat_plane(batch, cand, solver, wopts, windows):
    return _eval_step(concretize(batch), cand, solver, windows, wopts,
                      tail=True)


def slam_plane(batch, x, solver, wopts, windows, sense_max):
    return _slam_step(concretize(batch), x, solver, wopts, windows,
                      sense_max)


def shuf_plane(batch, x, solver, sid, wopts, windows):
    return _shuf_step(concretize(batch), x, solver, sid, wopts, windows)


class _PlaneBudget:
    """Host-side controller driving one plane's {full, lean} budget off
    its CERTIFICATION streak: lean after `stall_after` consecutive
    certified exchanges, full again the moment certification is lost.
    Certificates gate every published value identically at any budget."""

    def __init__(self, full: int, lean: int, stall_after: int):
        self.full = full
        self.lean = max(1, min(lean, full)) if full > 0 else 0
        self.stall_after = stall_after
        self.streak = 0

    def windows(self) -> int:
        if self.full <= 0:
            return 0
        return self.lean if self.streak >= self.stall_after else self.full

    def observe(self, certified: bool) -> None:
        self.streak = self.streak + 1 if certified else 0


class _ScalarCopy(HostCopy):
    """The packed scalars of one iteration on their way to the host.
    The candidate tensors stay on the device (transferred only when a
    spoke offers them)."""

    def __init__(self, scalars: Tensor, cands: dict):
        super().__init__([scalars])
        self.cands = cands

    @classmethod
    def of(cls, wstate: FusedWheelState):
        return cls(wstate.scalars, {"xhat": wstate.xhat_cand,
                                    "slam": wstate.slam_cand,
                                    "shuf": wstate.shuf_cand})


_ROUND_MODES = ("nearest", "ceil", "floor")


class FusedPH(ph_mod.PH):
    """PH driver whose iteration IS the whole wheel step.  Pair with the
    Fused* spokes (cylinders.spoke): they read bounds off the scalar
    cache instead of launching device work of their own."""

    def __init__(self, options, batch, wheel_options=None, **kw):
        super().__init__(options, batch, **kw)
        self.wheel_options = wheel_options or FusedWheelOptions()
        self.wstate: FusedWheelState | None = None
        self.scalar_cache: dict | None = None
        self.cand_cache: dict | None = None
        self._scalars_inflight: _ScalarCopy | None = None
        self._shuf_order = np.random.default_rng(42).permutation(
            batch.num_real)
        self._shuf_cursor = 0
        self._xhat_frozen_for = 0
        self._xhat_has_cand = False
        self._xhat_round_mode = "nearest"
        w = self.wheel_options
        stall = w.adapt_stall if w.adapt_budgets else (1 << 30)
        lag_stall = stall if w.adapt_lag_budget else (1 << 30)
        self._budgets = {
            "lag": _PlaneBudget(w.lag_windows, w.lean_lag_windows,
                                lag_stall),
            "xhat": _PlaneBudget(w.xhat_windows, w.lean_xhat_windows,
                                 stall),
            "slam": _PlaneBudget(w.slam_windows, w.lean_slam_windows,
                                 stall),
            "shuf": _PlaneBudget(w.shuffle_windows,
                                 w.lean_shuffle_windows, stall),
        }

    def _cache_scalars(self, pipelined: bool = False):
        """One device->host transfer per iteration: everything the hub
        and the fused spokes decide on.  Pipelined mode reads the
        PREVIOUS iteration's scalars right after dispatching the next
        step (total lag SCALAR_PIPELINE_DEPTH exchanges), so the host
        never waits for the step in flight; the candidates ride the same
        pipeline, so a cached value is always paired with the candidate
        it was evaluated at."""
        inflight = _ScalarCopy.of(self.wstate)
        ready = inflight
        if pipelined and self._scalars_inflight is not None:
            ready = self._scalars_inflight
        self._scalars_inflight = inflight
        # the ONE place the hub loop blocks on the device (and, sharded,
        # on the mesh: the scalars finish the iteration's all-reduces):
        # with an elastic MeshRuntime armed (parallel/elastic.py) the
        # read is deadline-bounded and chaos-seamed, so a straggler or a
        # lost host trips a typed MeshDegraded instead of hanging the
        # hub; without one it is the plain read
        spcomm = getattr(self, "spcomm", None)
        rt = None if spcomm is None \
            else spcomm.options.get("mesh_runtime")
        if rt is not None:
            vals = rt.harvest(lambda: np.array(ready.values()[0]),
                              hub_iter=self._iter)
        else:
            vals = ready.values()[0]
        self.scalar_cache = dict(zip(SCALAR_KEYS,
                                     (float(v) for v in vals)))
        self.cand_cache = ready.cands

    def flush_scalars(self):
        """Synchronize the cache to the LATEST iterate (final harvest)."""
        if self.wstate is not None:
            self._cache_scalars()

    def _read_conv(self) -> float:
        return self.scalar_cache["conv"]

    def state_template(self):
        return fused_state_template(self.batch, self.options,
                                    self.wheel_options)

    # -- the host half of the step cycle in a checkpoint -----------------
    _PLANES = ("lag", "xhat", "slam", "shuf")

    def checkpoint_extras(self) -> dict:
        """The host state the next iterations decide on, beside the
        device state a checkpoint already holds: the shuffle cursor, the
        x̂ candidate's freeze count and rounding mode, the planes' budget
        streaks, and the scalar pipeline (the cache the next step reads
        and the copy in flight, each with its candidates).  The hub
        writes them as `extra_` arrays (the JAX format's extras, which
        the JAX package ignores), so a restored wheel continues the
        uninterrupted trajectory; a snapshot without them restores as
        the JAX package's does, with a fresh cycle.  Tensors and the
        scalar copy in flight are handed over unread: the hub's writer
        waits on them, so a background save never drains the
        pipeline."""
        if self.wstate is None:
            return {}
        out = {"fw_cycle": np.asarray(
            [self._shuf_cursor, self._xhat_frozen_for,
             int(self._xhat_has_cand),
             _ROUND_MODES.index(self._xhat_round_mode)]
            + [self._budgets[p].streak for p in self._PLANES], np.int64)}
        if self.scalar_cache is not None:
            out["fw_cache"] = np.asarray(
                [self.scalar_cache[k] for k in SCALAR_KEYS], np.float64)
            for name, t in self.cand_cache.items():
                out[f"fw_cache_{name}"] = t
        if self._scalars_inflight is not None:
            out["fw_inflight"] = self._scalars_inflight
            for name, t in self._scalars_inflight.cands.items():
                out[f"fw_inflight_{name}"] = t
        return out

    def restore_extras(self, extras: dict) -> None:
        """Inverse of checkpoint_extras (a no-op without them)."""
        cycle = extras.get("fw_cycle")
        if cycle is None:
            return
        cycle = [int(v) for v in cycle]
        self._shuf_cursor, self._xhat_frozen_for = cycle[0], cycle[1]
        self._xhat_has_cand = bool(cycle[2])
        self._xhat_round_mode = _ROUND_MODES[cycle[3]]
        for p, streak in zip(self._PLANES, cycle[4:]):
            self._budgets[p].streak = streak
        dev = self.batch.device

        def cands(prefix):
            return {name: torch.as_tensor(np.array(
                extras[f"{prefix}_{name}"])).to(dev)
                for name in ("xhat", "slam", "shuf")}
        if "fw_cache" in extras:
            self.scalar_cache = dict(zip(
                SCALAR_KEYS, (float(v) for v in extras["fw_cache"])))
            self.cand_cache = cands("fw_cache")
        if "fw_inflight" in extras:
            self._scalars_inflight = _ScalarCopy(
                torch.as_tensor(np.array(extras["fw_inflight"])),
                cands("fw_inflight"))

    def _iter0_impl(self):
        self.wstate, tb, cert = fused_iter0(
            self.batch, self.rho, self.options, self.wheel_options)
        self._cache_scalars()
        return self.wstate.ph, tb, cert

    def _draw_spoke_cycle(self) -> tuple[int, bool]:
        """Draw the shuffle plane's scenario (the seed-42 order of
        ref:xhatshufflelooper_bounder.py:74), advance the cursor, and
        evaluate the spoke cadence for this iteration."""
        sid = int(self._shuf_order[self._shuf_cursor])
        self._shuf_cursor = (self._shuf_cursor + 1) % len(self._shuf_order)
        p = max(1, int(self.wheel_options.spoke_period))
        return sid, p <= 1 or (self._iter % p) == 0

    def _iterk_impl(self):
        sid, spoke_iter = self._draw_spoke_cycle()
        wopts = self.wheel_options
        split = wopts.split_dispatch
        if split is None:
            split = self.batch.num_real >= 512
        if split:
            self.wstate = self._iterk_split(sid, spoke_iter)
        else:
            w = wopts
            if not spoke_iter:
                # hub-only variant: spoke planes skipped, their state and
                # bounds carried untouched
                w = dataclasses.replace(w, lag_windows=0, xhat_windows=0,
                                        slam_windows=0, shuffle_windows=0)
            # self.state may have been rebound by extensions — fold it
            # back into the wheel state
            self.wstate = fused_iterk(
                self.batch, dataclasses.replace(self.wstate, ph=self.state),
                self.options, w, sid)
        self._cache_scalars(pipelined=True)
        if spoke_iter:
            self._observe_progress()
        return self.wstate.ph

    def _next_xhat_cand(self, xbar_nodes, current_cand):
        """The x̂ plane's freeze/rotate candidate policy.  The cached
        flags lag SCALAR_PIPELINE_DEPTH iterations, so right after an
        adoption they still describe the PREVIOUS candidate; trust them
        only once this candidate has been evaluated pipeline-depth
        exchanges."""
        sc = self.scalar_cache or {}
        wopts = self.wheel_options
        flags_fresh = self._xhat_frozen_for >= SCALAR_PIPELINE_DEPTH
        landed = flags_fresh and bool(sc.get("xhat_feasible", 0.0))
        dead = flags_fresh and bool(sc.get("xhat_dead", 0.0))
        give_up = self._xhat_frozen_for >= wopts.xhat_give_up
        if landed or dead or give_up or not self._xhat_has_cand:
            if (dead or give_up) and not landed:
                # escalate the rounding direction: nearest-rounding can
                # strand recourse demand; ceil opens every fractional
                # facility
                i = _ROUND_MODES.index(self._xhat_round_mode)
                self._xhat_round_mode = _ROUND_MODES[(i + 1) % 3]
            cand = _round_xbar(self.batch, xbar_nodes,
                               self._xhat_round_mode)
            self._xhat_frozen_for = 0
            self._xhat_has_cand = True
        else:
            cand = current_cand  # frozen: keep accumulating
            self._xhat_frozen_for += 1
        return cand

    def _iterk_split(self, sid: int, spoke_iter: bool) -> FusedWheelState:
        """One wheel iteration as a pipeline of steps: the hub PH step,
        then each enabled plane, then the scalar pack.  Nothing here
        waits on the device except the tail's `needed` read."""
        phst = ph_mod.ph_iterk(self.batch, self.state, self.options)
        out = dataclasses.replace(self.wstate, ph=phst)
        if spoke_iter:
            out = self._dispatch_spoke_planes(out, phst.W, phst.xbar_nodes,
                                              phst.solver.x, sid)
        return dataclasses.replace(out, scalars=_pack_scalars(out))

    def _dispatch_spoke_planes(self, out, W, xbar_nodes, x, sid,
                               dispatch=None):
        """The spoke-plane steps against one (W, x̄-nodes, x) view: the
        current step's outputs on the synchronous split path, the stale
        exchange plane on the async wheel.  `dispatch(label, fn, *args)`
        wraps each plane call (the async wheel routes them through plane
        tickets); the default calls fn directly."""
        if dispatch is None:
            def dispatch(label, fn, *args):
                return fn(*args)
        wopts = self.wheel_options
        batch = self.batch
        b = self._budgets
        if b["lag"].windows() > 0:
            ls, lb, lc = dispatch("lag", lag_plane, batch, W,
                                  out.lag_solver, wopts,
                                  b["lag"].windows())
            out = dataclasses.replace(
                out, lag_solver=ls, lag_bound=lb, lag_certified=lc)
        if b["xhat"].windows() > 0:
            cand = self._next_xhat_cand(xbar_nodes, out.xhat_cand)
            xs, xv, xf, xd = dispatch("xhat", xhat_plane, batch, cand,
                                      out.xhat_solver, wopts,
                                      b["xhat"].windows())
            out = dataclasses.replace(
                out, xhat_solver=xs, xhat_cand=cand, xhat_value=xv,
                xhat_feasible=xf, xhat_dead=xd)
        if b["slam"].windows() > 0:
            ss, scand, sv, sf = dispatch(
                "slam", slam_plane, batch, x, out.slam_solver, wopts,
                b["slam"].windows(), wopts.slam_sense_max)
            out = dataclasses.replace(
                out, slam_solver=ss, slam_cand=scand, slam_value=sv,
                slam_feasible=sf)
        if b["shuf"].windows() > 0:
            fs, fcand, fv, ff = dispatch(
                "shuf", shuf_plane, batch, x, out.shuf_solver, sid,
                wopts, b["shuf"].windows())
            out = dataclasses.replace(
                out, shuf_solver=fs, shuf_cand=fcand, shuf_value=fv,
                shuf_feasible=ff)
        return out

    def _observe_progress(self):
        """Feed the (pipeline-stale) certification flags to the budget
        controllers; staleness only delays a budget switch."""
        sc = self.scalar_cache
        if not sc:
            return
        self._budgets["lag"].observe(bool(sc["lag_certified"]))
        self._budgets["xhat"].observe(bool(sc["xhat_feasible"]))
        self._budgets["slam"].observe(bool(sc["slam_feasible"]))
        self._budgets["shuf"].observe(bool(sc["shuf_feasible"]))
