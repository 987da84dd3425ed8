###############################################################################
# Frank-Wolfe Progressive Hedging (port of mpisppy_tpu/algos/fwph.py;
# ref:mpisppy/fwph/fwph.py:58-307, Boland et al. 2018).
#
# Per scenario, FWPH keeps a set of columns (feasible points of X_s); each
# outer iteration runs a simplicial-decomposition inner loop:
#
#   1. linearization oracle v = argmin_{x in X_s} f_s(x) + What·x_non with
#      What = W + rho (x_t - xbar): one batched PDHG solve over every
#      scenario, warm-started across iterations;
#   2. at inner iteration 0 the oracle is the Lagrangian subproblem at a
#      valid multiplier (E_node[What] = 0), so its dual value is a true
#      dual bound, certified only when every real scenario's dual
#      residual clears 10 * tol;
#   3. v enters the column buffer, a fixed-size (S, K, n) ring with a
#      validity mask (least-weight eviction once full), and the inner QP
#      over the simplex of column weights is solved batched
#      (ops/simplex_qp.py) from Gram matrices built by batched matmuls;
#   4. Gamma, the FW gap, is recorded per scenario.
#
# After the inner loop: xbar <- node_average(x), W += rho (x - xbar), as
# in PH.  Nothing here reaches a kernel of its own: the oracle is the
# PDHG solver, on whatever engine window_engine names for the batch.
###############################################################################
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.core.batch import (
    ScenarioBatch, concretize, require_unsharded,
)
from mpisppy_tpu_torch.ops import boxqp, pdhg, simplex_qp

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FWPHOptions:
    """Options (ref FW_options, ref:mpisppy/utils/config.py fwph_args)."""

    fw_iter_limit: int = 2       # SDM inner iterations per outer iter
    fw_weight: float = 0.0       # alpha: linearization point mix
    fw_conv_thresh: float = 1e-4  # Gamma threshold
    max_columns: int = 16        # K: column ring-buffer size
    max_iterations: int = 50     # outer iteration limit
    conv_thresh: float = 1e-4    # PH-style convergence on ||x - xbar||
    default_rho: float = 1.0
    oracle_windows: int = 8      # PDHG restart windows per oracle solve
    iter0_windows: int = 400
    qp_iters: int = 300          # FISTA iterations for the simplex QP
    pdhg: pdhg.PDHGOptions = pdhg.PDHGOptions(tol=1e-6)
    display_progress: bool = False
    time_limit: float | None = None


@dataclasses.dataclass(frozen=True)
class FWPHState:
    cols: Tensor        # (S, K, n) scaled-space column buffer
    valid: Tensor       # (S, K) bool
    next_slot: int      # ring-buffer write cursor (shared; a host int)
    lam: Tensor         # (S, K) simplex weights
    x: Tensor           # (S, n) scaled-space current point V'lam
    W: Tensor           # (S, N) duals, original space
    xbar: Tensor        # (S, N)
    xbar_nodes: Tensor  # (num_nodes, N)
    conv: Tensor        # () scaled ||x - xbar||_1
    rho: Tensor         # (N,)
    oracle: pdhg.PDHGState
    bound: Tensor       # () last outer iteration's dual bound
    best_bound: Tensor  # () max over certified bounds
    certified: Tensor   # () bool for `bound`
    gamma: Tensor       # (S,) last FW gap per scenario


def _phi_parts(batch: ScenarioBatch, W: Tensor, xbar: Tensor, rho: Tensor):
    """(c_eff, q_eff) (S, n) of the PH objective
    phi(x) = f_s(x) + W·x_non + rho/2 ||x_non - xbar||^2 in scaled space."""
    qp_eff = batch.with_nonant_linear_quad(
        W - rho * xbar, torch.broadcast_to(rho, xbar.shape))
    return qp_eff.c, qp_eff.q


def _inner_qp(batch: ScenarioBatch, st: FWPHState):
    """Gram data of the inner QP, phi(V'lam) = 1/2 lam'H lam + g'lam +
    const: H = V diag(q_eff) V', g = V c_eff."""
    c_eff, q_eff = _phi_parts(batch, st.W, st.xbar, st.rho)
    H = torch.bmm(st.cols * q_eff[:, None, :], st.cols.transpose(1, 2))
    g = torch.bmm(st.cols, c_eff[:, :, None])[..., 0]
    return H, g


def _push_column(st: FWPHState, v: Tensor) -> FWPHState:
    """Add v to each scenario's column set: free slots in order while
    there are any, then each scenario's least-weight column is evicted
    (ring order was seen to discard columns still carrying weight)."""
    S, K, _ = st.cols.shape
    rows = torch.arange(S, device=v.device)
    if st.next_slot < K:
        slot = torch.full((S,), st.next_slot, dtype=torch.int64,
                          device=v.device)
    else:
        slot = torch.argmin(st.lam, dim=-1)
    cols = st.cols.clone()
    cols[rows, slot] = v
    valid = st.valid.clone()
    valid[rows, slot] = True
    lam = st.lam.clone()
    lam[rows, slot] = 0.0
    # renormalize away any (minimal) weight the evicted column carried
    tot = torch.clamp(lam.sum(dim=-1, keepdim=True), min=1e-12)
    return dataclasses.replace(st, cols=cols, valid=valid, lam=lam / tot,
                               next_slot=st.next_slot + 1)


def _certified_dual(batch: ScenarioBatch, qp: boxqp.BoxQP,
                    sol: pdhg.PDHGState, tol: float):
    """(E[dual value], certified): the dual bound of a solve, certified
    when every real scenario's dual residual is within 10 * tol."""
    dual = boxqp.dual_objective(qp, sol.x, sol.y)
    _, rd, _ = boxqp.kkt_residuals(qp, sol.x, sol.y)
    tol = max(tol, 5.0 * torch.finfo(sol.x.dtype).eps)
    real = batch.p > 0.0
    cert = torch.all(torch.where(real, rd <= 10.0 * tol, True))
    return batch.expectation(dual), cert


def fwph_iter(batch: ScenarioBatch, st: FWPHState,
              opts: FWPHOptions) -> FWPHState:
    """One FWPH outer iteration (Algorithm 3 lines 4-9 of Boland et al.;
    ref:mpisppy/fwph/fwph.py:147-307), on the batch's device."""
    batch = concretize(batch)
    x_non = batch.nonants(st.x)
    alpha = opts.fw_weight
    xt_non = (1.0 - alpha) * st.xbar + alpha * x_non
    dual0 = cert0 = None
    for t in range(opts.fw_iter_limit):
        What = st.W + st.rho * ((xt_non if t == 0 else x_non) - st.xbar)
        oracle_qp = batch.with_nonant_linear_quad(What, torch.zeros_like(What))
        oracle = pdhg.solve_fixed(oracle_qp, opts.oracle_windows, opts.pdhg,
                                  st.oracle)
        if t == 0:
            # the dual bound of inner iteration 0 (a valid multiplier)
            dual0, cert0 = _certified_dual(batch, oracle_qp, oracle,
                                           opts.pdhg.tol)
        # Gamma: the linearized-objective gap between the current point
        # and the vertex (ref:fwph.py:259-276)
        v = oracle.x
        c_lin, q_lin = _phi_parts(batch, What, torch.zeros_like(st.xbar),
                                  torch.zeros_like(st.rho))

        def phi_lin(xs):
            return torch.sum(c_lin * xs + 0.5 * q_lin * xs * xs, dim=-1)
        val_v = phi_lin(v)
        gamma = (phi_lin(st.x) - val_v) / torch.clamp(val_v.abs(), min=1.0)

        st = _push_column(dataclasses.replace(st, oracle=oracle), v)
        H, g = _inner_qp(batch, st)
        lam = simplex_qp.solve_simplex_qp(H, g, st.valid, st.lam,
                                          iters=opts.qp_iters)
        x = torch.bmm(lam[:, None, :], st.cols)[:, 0, :]
        st = dataclasses.replace(st, lam=lam, x=x, gamma=gamma)
        x_non = batch.nonants(x)
    if dual0 is None:
        dual0 = torch.full((), -float("inf"), dtype=st.x.dtype,
                           device=st.x.device)
        cert0 = torch.zeros((), dtype=torch.bool, device=st.x.device)

    # outer updates: xbar, conv, W (ref:fwph.py:186-205)
    xbar, xbar_nodes = batch.node_average(x_non)
    conv = batch.expectation(
        torch.sum((x_non - xbar).abs(), dim=-1)) / batch.num_nonants
    W = st.W + st.rho * (x_non - xbar)
    best = torch.where(cert0, torch.maximum(st.best_bound, dual0),
                       st.best_bound)
    return dataclasses.replace(st, xbar=xbar, xbar_nodes=xbar_nodes,
                               conv=conv, W=W, bound=dual0,
                               best_bound=best, certified=cert0)


def fwph_init(batch: ScenarioBatch, rho: Tensor, opts: FWPHOptions):
    """fw_prep (ref:mpisppy/fwph/fwph.py:97-145): Iter0-style cold solves
    seed the first column, xbar and W; the trivial bound comes from the
    dual side with a certificate.  Returns (state, bound, certified)."""
    batch = concretize(batch)
    S, N = batch.num_scenarios, batch.num_nonants
    n = batch.qp.c.shape[-1]
    K = opts.max_columns
    dt, dev = batch.qp.c.dtype, batch.device

    st0 = pdhg.init_state(batch.qp, opts.pdhg)
    solver = pdhg.solve_fixed(batch.qp, opts.iter0_windows, opts.pdhg, st0)
    trivial, cert = _certified_dual(batch, batch.qp, solver, opts.pdhg.tol)

    x = solver.x
    x_non = batch.nonants(x)
    xbar, xbar_nodes = batch.node_average(x_non)
    W = rho * (x_non - xbar)
    conv = batch.expectation(torch.sum((x_non - xbar).abs(), dim=-1)) / N

    cols = torch.zeros((S, K, n), dtype=dt, device=dev)
    cols[:, 0, :] = x
    valid = torch.zeros((S, K), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    lam = torch.zeros((S, K), dtype=dt, device=dev)
    lam[:, 0] = 1.0
    neg_inf = torch.full((), -float("inf"), dtype=dt, device=dev)
    st = FWPHState(
        cols=cols, valid=valid, next_slot=1, lam=lam, x=x, W=W, xbar=xbar,
        xbar_nodes=xbar_nodes, conv=conv, rho=rho, oracle=solver,
        bound=trivial, best_bound=torch.where(cert, trivial, neg_inf),
        certified=cert, gamma=torch.full((S,), float("inf"), dtype=dt,
                                         device=dev))
    return st, trivial, cert


class FWPH:
    """Host-side FWPH driver (ref:mpisppy/fwph/fwph.py:147-212).
    fwph_main() returns (iters, weight_dict, xbar_nodes) like the
    reference; .best_bound / ._local_bound carry the dual bounds."""

    def __init__(self, options: FWPHOptions, batch: ScenarioBatch,
                 scenario_names=None, rho: Tensor | float | None = None):
        require_unsharded(batch, "FWPH")
        self.options = options
        self.batch = batch
        self.scenario_names = scenario_names or [
            f"scen{i}" for i in range(batch.num_real)]
        if rho is None:
            rho = options.default_rho
        self.rho = torch.broadcast_to(
            torch.as_tensor(rho, dtype=batch.qp.c.dtype,
                            device=batch.device),
            (batch.num_nonants,)).clone()
        self.spcomm = None
        self.state: FWPHState | None = None
        self.trivial_bound: float | None = None
        self._local_bound: float = -np.inf
        self.best_bound: float = -np.inf
        self._iter = 0

    def fw_prep(self) -> float:
        self.state, tb, cert = fwph_init(self.batch, self.rho, self.options)
        self.trivial_bound = float(tb)
        if bool(cert):
            self.best_bound = self.trivial_bound
        global_toc(f"FWPH prep: trivial bound = {self.trivial_bound:.6g}",
                   self.options.display_progress)
        return self.trivial_bound

    def fwph_main(self):
        t0 = time.time()
        self.fw_prep()
        itr = 0
        for itr in range(1, self.options.max_iterations + 1):
            self._iter = itr
            self.state = fwph_iter(self.batch, self.state, self.options)
            self._local_bound = float(self.state.bound)
            self.best_bound = float(self.state.best_bound)
            conv = float(self.state.conv)
            global_toc(
                f"FWPH iter {itr}: bound={self._local_bound:.6g} "
                f"best={self.best_bound:.6g} conv={conv:.3e}",
                self.options.display_progress)
            if self.spcomm is not None:
                self.spcomm.sync()
                if self.spcomm.is_converged():
                    break
            if conv <= self.options.conv_thresh:
                break
            if (self.options.time_limit is not None
                    and time.time() - t0 > self.options.time_limit):
                break
        weights = {nm: self.state.lam[i].cpu().numpy()
                   for i, nm in enumerate(self.scenario_names)}
        return itr, weights, self.state.xbar_nodes.cpu().numpy()
