###############################################################################
# L-shaped (Benders) decomposition (port of mpisppy_tpu/algos/lshaped.py;
# ref:mpisppy/opt/lshaped.py:29-783).  Two-stage, min problems only.
#
#   * All scenario subproblems, first stage fixed at the master's x̂, are
#     ONE batched PDHG solve (_subproblem_cuts).
#   * Optimality cuts come from the DUAL side: for any iterate (x, y) of
#     the fixed-nonant subproblem the Fenchel bound is affine in x̂ with
#     slope the nonant reduced cost, so phi_s(x̂') >= alpha_s + g_s·x̂' is
#     valid even for inexact solves (weak duality).
#   * Feasibility cuts come from Farkas rays (the same recipe as
#     ops/boxqp.infeasibility_certificate), affine in x̂ through the
#     collapsed nonant box.
#   * The master is a BoxQP over [x_nonant; eta] with a fixed-capacity
#     cut buffer, single-cut (one eta) or multi-cut (eta_s per scenario).
#     It is solved as a batch of ONE problem, so on CUDA its windows run
#     in the window kernel like every other dense shared A
#     (ops/pdhg_window.plan_window picks the design: a 256-row cut buffer
#     is past the resident design's rows, and one problem takes the
#     split design, its columns and rows over many blocks).
#
# The JAX package jits each solve; here pdhg.solve is a host loop that
# reads `all(done)` once per window, so each iteration reports its
# windows (trace rows: sub_windows, master_windows).
#
# On a sharded batch (parallel/mesh.py) each rank solves its scenarios'
# subproblems; the host reads the cut pieces' GLOBAL rows (one
# all-gather, batch.scen_host), so every rank builds the same cut buffer,
# and rank 0 alone solves the master and broadcasts the next x̂ with its
# bound: the ranks cannot drift apart even where a kernel is not bitwise
# reproducible across cards.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.core.batch import (
    ScenarioBatch, concretize, is_root, mesh_broadcast, mesh_reduce,
)
from mpisppy_tpu_torch.ops import boxqp, pdhg
from mpisppy_tpu_torch.ops.boxqp import BoxQP

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LShapedOptions:
    """Static options (ref:mpisppy/opt/lshaped.py options dict:
    max_iter, tol, root_solver, valid_eta_lb)."""

    max_iter: int = 50
    tol: float = 1e-4              # relative ub-lb gap
    multicut: bool = False         # per-scenario eta (ref multi-cut mode)
    max_cuts: int = 256            # master cut-buffer capacity (rows)
    eta_lb: float | None = None    # valid lower bound on E[cost]; default:
    #                                wait-and-see dual bound - margin
    sub_pdhg: pdhg.PDHGOptions = pdhg.PDHGOptions(
        tol=1e-7, max_iters=100_000, detect_infeas=True)
    master_pdhg: pdhg.PDHGOptions = pdhg.PDHGOptions(
        tol=1e-7, max_iters=200_000)
    feas_tol: float = 1e-4         # primal-residual gate for ub validity
    display_progress: bool = False


def _windows(st: pdhg.PDHGState, opts: pdhg.PDHGOptions) -> int:
    return st.k // opts.restart_period


def _subproblem_cuts(batch: ScenarioBatch, xhat: Tensor,
                     opts: pdhg.PDHGOptions) -> dict:
    """Solve every scenario with nonants fixed at x̂ and extract, per
    scenario: the dual (outer) value, the optimality-cut slope, the
    primal objective and residual (inner-bound material), the status,
    and Farkas feasibility-cut pieces from two candidate rays
    (ref:mpisppy/opt/lshaped.py:387-513).  `windows` is the solve's
    restart-window count (the most any rank's solve ran)."""
    batch = concretize(batch)
    qp = batch.with_fixed_nonants(xhat)
    st = pdhg.solve(qp, opts)

    # D(x,y; x̂') = const + rc_non·(x̂'/d_non) for fixed (x, y): a valid
    # lower bound on phi_s(x̂'); g is the ORIGINAL-space slope
    dual = boxqp.dual_objective(qp, st.x, st.y)
    rc = qp.c + qp.q * st.x + qp.rmatvec(st.y)
    g = rc[..., batch.nonant_idx] / batch.d_non          # (S, N)
    alpha = dual - torch.sum(g * xhat, dim=-1)           # (S,)

    obj = boxqp.objective(qp, st.x)
    rp, rd, _ = boxqp.kkt_residuals(qp, st.x, st.y)

    def farkas_affine(y):
        """(qval, const, gf): certificate value at x̂ and its affine form
        qval(x̂') = const + gf·x̂' (<= 0 for a feasible x̂')."""
        nrm = torch.sum(torch.abs(y), dim=-1, keepdim=True)
        yn = y / torch.clamp(nrm, min=1e-30)
        z = qp.rmatvec(yn)
        ztol = 32.0 * torch.finfo(z.dtype).eps
        z = torch.where(torch.abs(z) <= ztol, torch.zeros_like(z), z)
        inf_j = torch.where(z > 0.0, z * qp.l, z * qp.u)
        inf_j = torch.where(z == 0.0, torch.zeros_like(inf_j), inf_j)
        sup_i = torch.where(yn > 0.0, yn * qp.bu, yn * qp.bl)
        sup_i = torch.where(yn == 0.0, torch.zeros_like(sup_i), sup_i)
        bad = (~torch.isfinite(inf_j)).any(dim=-1) \
            | (~torch.isfinite(sup_i)).any(dim=-1)
        qval = torch.sum(inf_j, dim=-1) - torch.sum(sup_i, dim=-1)
        gf = z[..., batch.nonant_idx] / batch.d_non
        const = qval - torch.sum(gf * xhat, dim=-1)
        qval = torch.where(bad, torch.full_like(qval, -float("inf")), qval)
        return qval, const, gf

    # candidate rays: the per-window displacement and the raw dual
    # iterate (ops/pdhg._restart's detection candidates)
    q1, c1, g1 = farkas_affine(st.y - st.y_anchor)
    q2, c2, g2 = farkas_affine(st.y)
    take2 = q2 > q1
    return dict(dual=dual, alpha=alpha, g=g, obj=obj, rp=rp, rd=rd,
                status=st.status, feas_qval=torch.maximum(q1, q2),
                feas_const=torch.where(take2, c2, c1),
                feas_g=torch.where(take2[..., None], g2, g1),
                windows=int(mesh_reduce(
                    batch, torch.tensor(_windows(st, opts),
                                        device=batch.device), "max")),
                state=st)


def _master_solve(qp: BoxQP, opts: pdhg.PDHGOptions):
    """Solve the (1-batched) master; returns (x, value, certified lower
    bound, dual residual, done, windows), each for the one problem."""
    st = pdhg.solve(qp, opts)
    val = boxqp.objective(qp, st.x)
    lb = boxqp.dual_objective(qp, st.x, st.y)
    _, rd, _ = boxqp.kkt_residuals(qp, st.x, st.y)
    return st.x[0], val[0], lb[0], rd[0], st.done[0], _windows(st, opts)


class LShapedMethod:
    """Host-side Benders driver (ref:mpisppy/opt/lshaped.py:29,515):
        ls = LShapedMethod(options, batch)
        result = ls.lshaped_algorithm()
    """

    def __init__(self, options: LShapedOptions | dict,
                 batch: ScenarioBatch, scenario_names=None):
        if isinstance(options, dict):
            options = LShapedOptions(**options)
        self.options = options
        self.batch = batch
        self.scenario_names = scenario_names
        if batch.tree.num_nodes != 1:
            raise ValueError("LShaped is two-stage only "
                             "(ref:mpisppy/opt/lshaped.py:29 docstring)")
        qnon = batch.qp.q[..., batch.nonant_idx]
        if float(mesh_reduce(batch, qnon.abs().max(), "max")) > 0.0:
            raise ValueError("LShaped requires linear first-stage cost "
                             "(quadratic nonant cost breaks cut affinity)")
        self._setup_master_box()
        self.xhat: np.ndarray | None = None
        self.lb = -np.inf
        self.ub = np.inf
        self.iterations = 0
        self.trace: list[dict] = []
        self.spcomm = None  # cylinder seam (ref:lshaped.py spcomm hooks)
        # the latest subproblem solve's PDHGState: the L-shaped hub
        # harvests its kernel counters (sub_pdhg.telemetry)
        self.sub_state = None

    def _setup_master_box(self):
        """First-stage box in original space: the tightest intersection
        across scenarios (p: the whole scenario axis)."""
        self._x_l, self._x_u = self.batch.nonant_box()
        self._N = self.batch.num_nonants
        self._p = self.batch.scen_host(self.batch.p).astype(np.float64)

    def _master_qp(self, cuts_A, cuts_bl, cuts_bu, eta_lb):
        """Master BoxQP over [x (N); eta (1 or S)] with the cut buffer,
        Ruiz-scaled at every rebuild (cut coefficients mix cost and value
        magnitudes), as a batch of one problem on the batch's device."""
        N = self._N
        n_eta = self.batch.scen_total if self.options.multicut else 1
        c = np.zeros(N + n_eta)
        if self.options.multicut:
            c[N:] = self._p
        else:
            c[N] = 1.0
        eta_lb = np.broadcast_to(np.asarray(eta_lb, np.float64), (n_eta,))
        l = np.concatenate([self._x_l, eta_lb])  # noqa: E741
        u = np.concatenate([self._x_u, np.full(n_eta, np.inf)])
        qp = boxqp.make_boxqp(c, cuts_A, cuts_bl, cuts_bu, l, u,
                              device=self.batch.device)
        qp, scaling = boxqp.ruiz_scale(qp)
        return boxqp.one_problem(qp), scaling

    def _master_step(self, cuts_A, cuts_bl, cuts_bu, eta_lb):
        """(x̂, lower bound, dual residual, windows) of the master: rank
        0 solves it and broadcasts them (f64) to every rank."""
        N = self._N
        b = self.batch
        msg = np.zeros(N + 3)
        if is_root(b):
            qp_m, scal = self._master_qp(cuts_A, cuts_bl, cuts_bu, eta_lb)
            xm, _, lb_m, rd_m, _, m_windows = _master_solve(
                qp_m, self.options.master_pdhg)
            x_orig = xm.cpu().numpy().astype(np.float64) * scal.d_col
            msg[:N] = x_orig[:N]
            msg[N:] = float(lb_m), float(rd_m), m_windows
        msg = mesh_broadcast(b, torch.as_tensor(
            msg, dtype=torch.float64, device=b.device)).cpu().numpy()
        return (np.clip(msg[:N], self._x_l, self._x_u), float(msg[N]),
                float(msg[N + 1]), int(msg[N + 2]))

    def lshaped_algorithm(self) -> dict:
        """ref:mpisppy/opt/lshaped.py:515 lshaped_algorithm()."""
        opts = self.options
        b = self.batch
        N = self._N
        n_eta = b.scen_total if opts.multicut else 1
        ncols = N + n_eta
        real = self._p > 0.0
        dt, dev = b.qp.c.dtype, b.device

        # iter 0: unrestricted scenario solves give the wait-and-see
        # bound (default eta_lb) and the first x̂ = E[x_non]
        st0 = self.sub_state = pdhg.solve(b.qp, opts.sub_pdhg)
        ws_dual = boxqp.dual_objective(b.qp, st0.x, st0.y)
        ws = float(b.expectation(ws_dual))
        if opts.eta_lb is not None:
            eta_lb = opts.eta_lb
        elif opts.multicut:
            # per-scenario eta_s needs a PER-SCENARIO valid lower bound
            wsd = b.scen_host(ws_dual).astype(np.float64)
            eta_lb = wsd - 0.05 * np.abs(wsd) - 1.0
            eta_lb[~real] = 0.0  # padded scenarios: p=0, keep bounded
        else:
            eta_lb = ws - 0.05 * abs(ws) - 1.0
        x_non0 = b.nonants(st0.x)
        xhat = b.scen_sum(b.p[:, None] * x_non0).cpu().numpy()
        xhat = np.clip(xhat.astype(np.float64), self._x_l, self._x_u)

        # host-side master cut buffer (float64; fixed shapes)
        cuts_A = np.zeros((opts.max_cuts, ncols))
        cuts_bl = np.full(opts.max_cuts, -np.inf)
        cuts_bu = np.full(opts.max_cuts, np.inf)
        ncuts = 0

        def add_row(row, bl=-np.inf, bu=np.inf):
            nonlocal ncuts
            # a full buffer overwrites the oldest cut (a ring)
            idx = ncuts % opts.max_cuts
            cuts_A[idx] = row
            cuts_bl[idx] = bl
            cuts_bu[idx] = bu
            ncuts += 1

        self.lb, self.ub = -np.inf, np.inf
        best_xhat = xhat.copy()
        for t in range(1, opts.max_iter + 1):
            self.iterations = t
            res = _subproblem_cuts(b, torch.as_tensor(xhat, dtype=dt,
                                                      device=dev),
                                   opts.sub_pdhg)
            self.sub_state = res["state"]
            keys = [k for k, v in res.items() if isinstance(v, Tensor)]
            host = dict(zip(keys, b.scen_host(*(res[k] for k in keys))))
            infeas = real & (host["status"] == pdhg.INFEASIBLE)
            cuts_before = ncuts
            if infeas.any():
                # feasibility cuts for every certified-infeasible scenario
                consts = host["feas_const"].astype(np.float64)
                gfs = host["feas_g"].astype(np.float64)
                qvals = host["feas_qval"].astype(np.float64)
                for s in np.nonzero(infeas)[0]:
                    if not np.isfinite(qvals[s]) or qvals[s] <= 0.0:
                        continue  # no usable affine certificate
                    row = np.zeros(ncols)
                    row[:N] = gfs[s]
                    add_row(row, bu=-consts[s])
                if ncuts == cuts_before:
                    # no usable certificate: the master would re-solve the
                    # identical problem, so stop instead of livelocking
                    global_toc("LShaped: infeasible subproblem(s) with no "
                               "usable Farkas certificate; stopping", True)
                    break
            else:
                # inner bound: the primal objective is valid when every
                # real scenario is primal-feasible at tolerance
                obj = host["obj"].astype(np.float64)
                if np.all(host["rp"][real] <= opts.feas_tol):
                    ub_t = float(np.sum(self._p * obj))
                    if ub_t < self.ub:
                        self.ub = ub_t
                        best_xhat = xhat.copy()
                alpha = host["alpha"].astype(np.float64)
                gmat = host["g"].astype(np.float64)
                if opts.multicut:
                    for s in np.nonzero(real)[0]:
                        row = np.zeros(ncols)
                        row[:N] = -gmat[s]
                        row[N + s] = 1.0
                        add_row(row, bl=alpha[s])
                else:
                    row = np.zeros(ncols)
                    row[:N] = -np.sum(self._p[:, None] * gmat, axis=0)
                    row[N] = 1.0
                    add_row(row, bl=float(np.sum(self._p * alpha)))

            xhat, lb_m, rd_m, m_windows = self._master_step(
                cuts_A, cuts_bl, cuts_bu, eta_lb)
            if rd_m <= 10.0 * opts.master_pdhg.tol:
                self.lb = max(self.lb, lb_m)

            gap = self.ub - self.lb
            rel = gap / max(1e-10, abs(self.ub)) if np.isfinite(gap) \
                else np.inf
            self.trace.append(dict(iter=t, lb=self.lb, ub=self.ub,
                                   rel_gap=rel,
                                   ncuts=min(ncuts, opts.max_cuts),
                                   sub_windows=res["windows"],
                                   master_windows=m_windows))
            global_toc(f"LShaped iter {t}: lb {self.lb:.6g} "
                       f"ub {self.ub:.6g} rel_gap {rel:.3e}",
                       opts.display_progress)
            if self.spcomm is not None:
                # publish the FRESH master candidate: the x̂-L-shaped
                # spoke evaluates candidates the hub has not certified
                self.xhat = xhat.copy()
                self.spcomm.sync()
                if self.spcomm.is_converged():
                    break
            if rel <= opts.tol:
                break

        self.xhat = best_xhat
        return dict(bound=self.lb, ub=self.ub, xhat=best_xhat,
                    iterations=self.iterations, trace=self.trace)

    def first_stage_solution(self) -> np.ndarray:
        return self.xhat

    def nonant_values(self) -> np.ndarray:
        return self.xhat[None, :]
