###############################################################################
# Asynchronous Projective Hedging (port of mpisppy_tpu/algos/aph.py;
# ref:mpisppy/opt/aph.py, after Eckstein et al.).  Per iteration
# (Algorithm 2 of the paper; ref:opt/aph.py:277-443,445-658):
#
#   y_s   = W_s + rho (x_s - z)      for scenarios solved last round (Eq.25)
#   xbar  = node_avg(x),  ybar = node_avg(y)        (FirstReduce)
#   u_s   = x_s - xbar               (Eq.27),  v = ybar
#   tau   = E[ ||u||^2 + ||v||^2 / gamma ]
#   phi   = E[ (z - x)·(W - y) ]                    (SecondReduce)
#   theta = nu * phi / tau   (0 when tau<=0 or phi<=0; Steps 16-17)
#   W    += theta * u                               (Step 19)
#   z    += theta * ybar / gamma   (z = xbar at the first iteration)
#   conv  = ||u||_p/||W||_p + ||v||_p/||z||_p       (ref:opt/aph.py:658-686)
#
# The update is tensor math over the scenario batch; node averages are
# the same reductions PH uses.  Fractional dispatch is a MASK: every
# iteration the ceil(dispatch_frac * S) stalest scenarios are selected
# (round-robin on ties, first index first), the whole batch's warm solve
# runs — in the window kernel on CUDA every lane runs — and the solver
# state is merged by the mask afterwards, so scenarios not dispatched
# keep their previous iterates and bookkeeping exactly.
#
# All four norms are probability-weighted (the JAX package's documented
# deviation from the reference's unweighted u/v sums; identical up to a
# constant factor for uniform probabilities, which cancels in theta).
###############################################################################
from __future__ import annotations

import dataclasses
import math

import torch

from mpisppy_tpu_torch.algos.ph import PH, iter0_solve_and_certify, \
    ph_eobjective
from mpisppy_tpu_torch.core.batch import ScenarioBatch, require_unsharded
from mpisppy_tpu_torch.ops import pdhg

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class APHOptions:
    """APH options (ref Config group aph_args,
    ref:mpisppy/utils/config.py:396-430)."""

    default_rho: float = 1.0
    max_iterations: int = 100          # ref 'aph_max_iterations'
    conv_thresh: float = 1e-4
    gamma: float = 1.0                 # ref 'aph_gamma'
    nu: float = 1.0                    # ref 'aph_nu' (step scaling)
    dispatch_frac: float = 1.0         # ref 'aph_dispatch_frac'
    use_dynamic_gamma: bool = False    # ref _calculate_APHgamma
    subproblem_windows: int = 8
    iter0_windows: int = 400
    pdhg: pdhg.PDHGOptions = pdhg.PDHGOptions(tol=1e-6)
    display_progress: bool = False
    time_limit: float | None = None


@dataclasses.dataclass(frozen=True)
class APHState:
    solver: pdhg.PDHGState  # scaled-space subproblem iterates
    W: Tensor               # (S, N) duals, original space
    y: Tensor               # (S, N) projective-splitting auxiliary duals
    z: Tensor               # (S, N) per-scenario view of the z center
    xbar: Tensor            # (S, N) per-scenario view of node averages
    xbar_nodes: Tensor      # (num_nodes, N)
    ybar_nodes: Tensor      # (num_nodes, N)
    conv: Tensor            # () APH convergence metric
    theta: Tensor           # () last projective step length
    rho: Tensor             # (N,) penalty
    gamma: Tensor           # () APH gamma
    last_solved: Tensor     # (S,) int32 iteration s was last dispatched
    it: Tensor              # () int32 APH iteration counter
    pusq_prev: Tensor       # () previous ||u||_p^2 (dynamic gamma memory)
    pvsq_prev: Tensor       # () previous ||v||_p^2


def _merge_solver(mask: Tensor, new: pdhg.PDHGState,
                  old: pdhg.PDHGState) -> pdhg.PDHGState:
    """Keep `new` solver lanes only for dispatched scenarios (the lanes
    of a batched PDHG state are independent), the kernel counters' lanes
    too; the host iteration count and the ring cursor follow `new`."""
    if new is None or old is None:
        return new
    kw = {}
    for f in dataclasses.fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if dataclasses.is_dataclass(a):
            kw[f.name] = _merge_solver(mask, a, b)
        elif isinstance(a, Tensor) and a.ndim > 0:
            m = mask.reshape(mask.shape + (1,) * (a.ndim - 1))
            kw[f.name] = torch.where(m, a, b)
        else:
            kw[f.name] = a
    return dataclasses.replace(new, **kw)


def aph_iter0(batch: ScenarioBatch, rho: Tensor, opts: APHOptions):
    """Iter0: plain scenario solves (no W, no prox), z = xbar, y = 0,
    dual-certified trivial bound (ref:opt/aph.py:992-1067).  Returns
    (state, trivial_bound, certified)."""
    solver, trivial_bound, certified = iter0_solve_and_certify(
        batch, opts.iter0_windows, opts.pdhg)
    x_non = batch.nonants(solver.x)
    xbar, xbar_nodes = batch.node_average(x_non)
    S, N = x_non.shape
    dt, dev = batch.qp.c.dtype, batch.device

    def scalar(v, dtype=dt):
        return torch.tensor(v, dtype=dtype, device=dev)

    zeros = torch.zeros((S, N), dtype=dt, device=dev)
    st = APHState(
        solver=solver, W=zeros, y=zeros.clone(), z=xbar, xbar=xbar,
        xbar_nodes=xbar_nodes, ybar_nodes=torch.zeros_like(xbar_nodes),
        conv=scalar(float("inf")), theta=scalar(0.0), rho=rho,
        gamma=scalar(opts.gamma),
        last_solved=torch.zeros(S, dtype=torch.int32, device=dev),
        it=scalar(0, torch.int32), pusq_prev=scalar(0.0),
        pvsq_prev=scalar(0.0))
    return st, trivial_bound, certified


def aph_state_template(batch: ScenarioBatch, opts: APHOptions) -> APHState:
    """aph_iter0's state as shapes and dtypes (meta-device tensors, no
    solve) — the unflatten template of an APH checkpoint restore.  The
    JAX package's APH inherits PH's template and restores no APH
    snapshot; the port restores them (ROADMAP.md C1)."""
    S, N = batch.num_scenarios, batch.num_nonants
    dt = batch.qp.c.dtype
    nodes = batch.tree.num_nodes

    def t(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    return APHState(
        solver=pdhg.state_template((S,), batch.qp.n, batch.qp.m, dt,
                                   opts.pdhg),
        W=t(S, N), y=t(S, N), z=t(S, N), xbar=t(S, N),
        xbar_nodes=t(nodes, N), ybar_nodes=t(nodes, N), conv=t(),
        theta=t(), rho=t(N), gamma=t(),
        last_solved=t(S, dtype=torch.int32), it=t(dtype=torch.int32),
        pusq_prev=t(), pvsq_prev=t())


def _row_sq(v: Tensor) -> Tensor:
    return torch.sum(v * v, dim=-1)


def projective_theta(batch: ScenarioBatch, x_non: Tensor, xbar: Tensor,
                     W: Tensor, z_plane: Tensor, W_plane: Tensor,
                     rho: Tensor, nu: float = 1.0,
                     gamma: float = 1.0) -> Tensor:
    """APH Steps 16-17 (tau/phi/theta) against an arbitrary prox center
    (the damping of a stale-plane step): y formed at the plane's era
    (y = W_plane + rho (x - z_plane)), phi = E<z - x, W - y> measured
    against the CURRENT duals, theta = nu phi / tau, 0 when phi <= 0
    (the rejection branch), clipped to [0, 1]."""
    u = x_non - xbar                               # Eq. 27
    y = W_plane + rho * (x_non - z_plane)          # Eq. 25, plane era
    ybar, _ = batch.node_average(y)
    tau = batch.expectation(_row_sq(u)) \
        + batch.expectation(_row_sq(ybar)) / gamma
    phi = batch.expectation(torch.sum((z_plane - x_non) * (W - y), dim=-1))
    theta = torch.where((tau > 0) & (phi > 0),
                        nu * phi / torch.clamp(tau, min=1e-30),
                        torch.zeros_like(tau))
    return torch.clamp(theta, 0.0, 1.0).to(x_non.dtype)


def _dispatch_mask(batch: ScenarioBatch, st: APHState,
                   n_dispatch: int) -> Tensor:
    """The n_dispatch stalest real scenarios (the dispatch record,
    ref:opt/aph.py:164-168,756+: least recently solved first); equal
    staleness round-robins through a rotating offset, and exact ties go
    to the lower index (top-k as a stable descending sort)."""
    S = batch.num_scenarios
    dev = batch.device
    if n_dispatch >= S:
        return torch.ones(S, dtype=torch.bool, device=dev)
    staleness = (st.it - st.last_solved).to(torch.float32)
    # padded scenarios never win a slot over real ones
    staleness = torch.where(batch.p > 0.0, staleness,
                            torch.full_like(staleness, -1.0))
    idx = torch.arange(S, dtype=torch.float32, device=dev)
    rot = torch.remainder(idx - st.it.to(torch.float32), S) / (2.0 * S)
    order = torch.sort(staleness + rot, descending=True, stable=True)[1]
    mask = torch.zeros(S, dtype=torch.bool, device=dev)
    mask[order[:n_dispatch]] = True
    return mask


def aph_iterk(batch: ScenarioBatch, st: APHState,
              opts: APHOptions) -> APHState:
    """One APH iteration: the projective step (averages, tau/phi/theta,
    W/z), then the masked partial dispatch of warm subproblem solves
    (ref:opt/aph.py:877-989 APH_iterk, reordered so the step uses the
    iterates of the previous dispatch)."""
    it = st.it + 1
    dt = batch.qp.c.dtype
    S, N = batch.num_scenarios, batch.num_nonants

    # FirstReduce: st.xbar IS the node average of the stored iterates
    x_non = batch.nonants(st.solver.x)
    xbar = st.xbar
    ybar, ybar_nodes = batch.node_average(st.y)
    u = x_non - xbar                       # Eq. 27
    v = ybar
    pusq = batch.expectation(_row_sq(u))
    pvsq = batch.expectation(_row_sq(v))

    # dynamic gamma (ref:opt/aph.py:228-275): only after iteration 3,
    # only when both norms and both decrease ratios are positive
    if opts.use_dynamic_gamma:
        u_term = (st.pusq_prev - pusq) / torch.clamp(pusq, min=1e-30)
        v_term = (st.pvsq_prev - pvsq) / torch.clamp(pvsq, min=1e-30)
        ok = (it > 3) & (pusq > 0) & (pvsq > 0) & (u_term > 0) \
            & (v_term > 0)
        gamma = torch.where(ok, v_term / torch.clamp(u_term, min=1e-30),
                            st.gamma)
        pusq_prev = torch.where(ok | (it <= 3), pusq, st.pusq_prev)
        pvsq_prev = torch.where(ok | (it <= 3), pvsq, st.pvsq_prev)
    else:
        gamma = st.gamma
        pusq_prev, pvsq_prev = pusq, pvsq

    # SecondReduce, Steps 16-19 (ref:opt/aph.py:330-443,579-658)
    tau = pusq + pvsq / gamma
    phi = batch.expectation(torch.sum((st.z - x_non) * (st.W - st.y),
                                      dim=-1))
    theta = torch.where((tau > 0) & (phi > 0),
                        opts.nu * phi / torch.clamp(tau, min=1e-30),
                        torch.zeros_like(tau))
    W = st.W + theta * u
    z = torch.where(it == 1, xbar, st.z + theta * ybar / gamma)

    pwn = torch.sqrt(batch.expectation(_row_sq(W)))
    pzn = torch.sqrt(batch.expectation(_row_sq(z)))
    conv = torch.where(
        (pwn > 0) & (pzn > 0),
        torch.sqrt(pusq) / torch.clamp(pwn, min=1e-30)
        + torch.sqrt(pvsq) / torch.clamp(pzn, min=1e-30),
        torch.full_like(pwn, float("inf")))

    # partial dispatch; iteration 1 dispatches everyone
    # (ref:opt/aph.py:955-958)
    n_dispatch = max(1, int(math.ceil(opts.dispatch_frac * batch.num_real)))
    mask = _dispatch_mask(batch, dataclasses.replace(st, it=it), n_dispatch)
    mask = mask | (it == 1)

    # f_s(x) + W·x + rho/2 (x - z)^2: the prox is around z
    # (ref:opt/aph.py:1040-1062)
    qp_eff = batch.with_nonant_linear_quad(
        W - st.rho * z, torch.broadcast_to(st.rho, (S, N)))
    solved = pdhg.solve_fixed(qp_eff, opts.subproblem_windows, opts.pdhg,
                              st.solver)
    solver = _merge_solver(mask, solved, st.solver)

    # y at solve time with the same (W, z) the objective used (Eq. 25)
    x_new = batch.nonants(solver.x)
    y = torch.where(mask[:, None], W + st.rho * (x_new - z), st.y)
    last_solved = torch.where(mask, it, st.last_solved)
    xbar_new, xbar_nodes_new = batch.node_average(x_new)
    return dataclasses.replace(
        st, solver=solver, W=W, y=y, z=z, xbar=xbar_new,
        xbar_nodes=xbar_nodes_new, ybar_nodes=ybar_nodes, conv=conv,
        theta=theta.to(dt), gamma=gamma, last_solved=last_solved, it=it,
        pusq_prev=pusq_prev, pvsq_prev=pvsq_prev)


aph_eobjective = ph_eobjective  # the same reduction: any state with .solver


class APH(PH):
    """Host-side APH driver (ref:mpisppy/opt/aph.py:992-1161 APH_main):
    the PH driver's extension, converger and spcomm plumbing with APH's
    steps.  `APH_main() -> (conv, Eobj, trivial_bound)`; Eobj is
    E[f_s(x_s)] at the final iterates (no prox term)."""

    _label = "APH"

    def __init__(self, options: APHOptions, batch: ScenarioBatch, **kw):
        require_unsharded(batch, "APH")
        super().__init__(options, batch, **kw)
        self.state: APHState | None = None

    def state_template(self):
        return aph_state_template(self.batch, self.options)

    def _iter0_impl(self):
        return aph_iter0(self.batch, self.rho, self.options)

    def _iterk_impl(self):
        return aph_iterk(self.batch, self.state, self.options)

    def _iter_msg(self, k: int, conv: float) -> str:
        return (f"APH iter {k}: conv = {conv:.3e} "
                f"theta = {float(self.state.theta):.3e}")

    def APH_main(self):
        """Returns (conv, Eobj, trivial_bound) (ref:opt/aph.py:992+)."""
        return self.ph_main()
