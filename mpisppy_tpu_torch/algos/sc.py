###############################################################################
# Schur-complement interior point (port of mpisppy_tpu/algos/sc.py;
# ref:mpisppy/opt/sc.py:32-114, parapint's MPI Schur-complement IP with
# per-scenario HSL MA27 factorizations; continuous two-stage only).
#
#   min sum_s p_s (c_s'v_s + 1/2 v_s'Q_s v_s)
#   s.t. per scenario:  A_s v_s in [bl, bu]  (slacks t on ineq rows),
#                       box on v_s,   E v_s - x = 0  (consensus rows)
#
# One Mehrotra predictor-corrector iteration:
#   * diagonal D_s = Q + barrier terms (q is diagonal, so D is too);
#   * per-scenario NORMAL matrices M_s = G_s D_s^-1 G_s' and their
#     batched Cholesky factorizations (torch.linalg, batched over the
#     scenario axis);
#   * the N x N SCHUR complement on the consensus block, summed over
#     scenarios, one small dense solve for dx and batched
#     back-substitution.
#
# Precision: the Newton systems need f64 (the reference's MA27 is f64 for
# the same reason).  The whole loop runs in f64 on the batch's device:
# on CUDA that is the card (an H100 has full-rate f64), never f32.  The
# JAX package runs the same loop under x64 on the host CPU.
#
# On a sharded batch (parallel/mesh.py) each rank factors its scenarios'
# blocks; every scenario reduction finishes with one all-reduce: the
# shared normalizations, the Schur sum K and its right-hand side, rx,
# the complementarity mean, the step lengths and the stopping tests.
# The N-vector x is replicated: every rank solves the same small system.
###############################################################################
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.core.batch import ScenarioBatch, mesh_reduce
from mpisppy_tpu_torch.ops.sparse import EllMatrix

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SCOptions:
    max_iter: int = 60
    tol: float = 1e-8          # mu target
    frac_to_bound: float = 0.995
    display_progress: bool = False


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _gmax(batch: ScenarioBatch, v) -> np.ndarray:
    """A host f64 max finished over the batch's mesh."""
    return mesh_reduce(batch, torch.as_tensor(np.asarray(v, np.float64),
                                              device=batch.device),
                       "max").cpu().numpy()


def _structure(batch: ScenarioBatch) -> dict:
    """Problem structure (host side, f64): dense G blocks, the slack
    layout, boxes and costs, normalized.  Needs a shared equality-row
    pattern across scenarios, no integer slot and a two-stage tree.  The
    shared scales (nonant columns, objective, consensus rows) are taken
    over the whole scenario axis."""
    qp = batch.qp
    S, n, m = batch.num_scenarios, qp.n, qp.m
    bl = np.broadcast_to(_host(qp.bl), (S, m))
    bu = np.broadcast_to(_host(qp.bu), (S, m))
    eq = np.isclose(bl, bu)
    ref = mesh_reduce(batch, torch.as_tensor(eq[0], device=batch.device),
                      "min").cpu().numpy()
    same = mesh_reduce(batch, torch.as_tensor(
        bool((eq == ref[None]).all()), device=batch.device), "min")
    if not bool(same):
        raise ValueError("SchurComplement needs a shared equality-row "
                         "pattern across scenarios")
    eq = eq[0]
    if bool(batch.integer_slot.any()):
        raise ValueError("SchurComplement supports continuous problems "
                         "only (ref:mpisppy/opt/sc.py docstring)")
    if batch.tree.num_nodes != 1:
        raise ValueError("SchurComplement is two-stage only")
    ineq = ~eq
    m_in = int(ineq.sum())
    N = batch.num_nonants

    if isinstance(qp.A, EllMatrix):  # dense anyway: SC factors dense blocks
        vals, cols = _host(qp.A.vals), qp.A.cols.cpu().numpy()
        rows = np.repeat(np.arange(m), cols.shape[1])
        if vals.ndim == 2:
            dense = np.zeros((m, n))
            np.add.at(dense, (rows, cols.reshape(-1)), vals.reshape(-1))
            A = np.broadcast_to(dense, (S, m, n))
        else:
            A = np.zeros((S, m, n))
            for s in range(S):
                np.add.at(A[s], (rows, cols.reshape(-1)),
                          vals[s].reshape(-1))
    else:
        A = np.broadcast_to(_host(qp.A), (S, m, n))

    # per scenario: w = [v (n); t (m_in)]; rows: m (A) + N (consensus)
    nw = n + m_in
    G = np.zeros((S, m + N, nw))
    G[:, :m, :n] = A
    G[:, np.nonzero(ineq)[0], n + np.arange(m_in)] = -1.0
    nonant_idx = batch.nonant_idx.cpu().numpy()
    # consensus ties ORIGINAL-space nonants: the batch's Ruiz scalings
    # are per-scenario, so the row coefficient is d_non[s, j]
    d_non = np.broadcast_to(_host(batch.d_non), (S, N))
    for j in range(N):
        G[:, m + j, nonant_idx[j]] = d_non[:, j]

    b = np.zeros((S, m + N))
    b[:, np.nonzero(eq)[0]] = bl[:, eq]
    lw = np.concatenate([np.broadcast_to(_host(qp.l), (S, n)),
                         bl[:, ineq]], axis=1)
    uw = np.concatenate([np.broadcast_to(_host(qp.u), (S, n)),
                         bu[:, ineq]], axis=1)
    cw = np.concatenate([np.broadcast_to(_host(qp.c), (S, n)),
                         np.zeros((S, m_in))], axis=1)
    qw = np.concatenate([np.broadcast_to(_host(qp.q), (S, n)),
                         np.zeros((S, m_in))], axis=1)

    # IPM-side normalization: every BOX to O(1) by a per-column scale
    # (shared across scenarios on the nonant columns, so x is well
    # defined), the objective to O(1), every G row to unit norm (the
    # consensus rows with one shared scale)
    finite_mag = np.maximum(np.where(np.isfinite(lw), np.abs(lw), 0.0),
                            np.where(np.isfinite(uw), np.abs(uw), 0.0))
    col_s = np.maximum(1.0, finite_mag)            # (S, nw)
    col_s[:, nonant_idx] = _gmax(batch, col_s[:, nonant_idx].max(axis=0))
    G = G * col_s[:, None, :]
    lw, uw = lw / col_s, uw / col_s
    cw, qw = cw * col_s, qw * col_s * col_s
    obj_scale = max(1.0, float(_gmax(batch, np.abs(cw).max())))
    cw, qw = cw / obj_scale, qw / obj_scale
    row_s = np.maximum(np.linalg.norm(G, axis=2), 1e-8)  # (S, m+N)
    row_s[:, m:] = _gmax(batch, row_s[:, m:].max(axis=0))
    G = G / row_s[:, :, None]
    b = b / row_s
    # the solved x is original-space up to the shared consensus row
    # scale, undone in solve()
    return dict(G=G, b=b, lw=lw, uw=uw, cw=cw, qw=qw, n=n, m=m,
                m_in=m_in, N=N, col_s=col_s, x_row_scale=row_s[0, m:])


def _sc_solve(G: Tensor, b: Tensor, lw: Tensor, uw: Tensor, cw: Tensor,
              qw: Tensor, p: Tensor, N: int, opts: SCOptions, batch=None):
    """Batched Mehrotra predictor-corrector in the dtype of G (f64).
    Shapes: G (S, mc, nw), b (S, mc), boxes/costs (S, nw), p (S,).  The
    LAST N rows of G are the consensus rows; their x coupling is
    J = -I.  Returns the best iterate (w, x), done, its mu and its
    residual.  `batch`: the sharded batch whose mesh finishes every
    scenario reduction (None: these rows are the whole axis)."""

    def red(t, op):
        return mesh_reduce(batch, t, op)
    S, mc, nw = G.shape
    dt, dev = G.dtype, G.device
    eps = torch.finfo(dt).eps
    has_l, has_u = torch.isfinite(lw), torch.isfinite(uw)
    zero = torch.zeros((), dtype=dt, device=dev)
    l_safe = torch.where(has_l, lw, zero)
    u_safe = torch.where(has_u, uw, zero)
    n_act = float(max(int(red(has_l.sum() + has_u.sum(), "sum")), 1))

    # objective scaled by p so the consensus duals balance globally
    cw = p[:, None] * cw
    qw = p[:, None] * qw

    # interior start: midpoint of finite boxes, 1.0 margin one-sided;
    # duals at the COST scale (Mehrotra-style)
    w = torch.where(has_l & has_u, 0.5 * (l_safe + u_safe),
                    torch.where(has_l, l_safe + 1.0,
                                torch.where(has_u, u_safe - 1.0, zero)))
    z0 = 1.0 + torch.abs(cw)
    zl = torch.where(has_l, z0, zero)
    zu = torch.where(has_u, z0, zero)
    y = torch.zeros((S, mc), dtype=dt, device=dev)
    x = torch.zeros((N,), dtype=dt, device=dev)
    EJ = torch.zeros((mc, N), dtype=dt, device=dev)
    EJ[mc - N:, :] = -torch.eye(N, dtype=dt, device=dev)
    eye_mc = torch.eye(mc, dtype=dt, device=dev)
    floor = eps ** 0.9
    scale_p = 1.0 + float(red(torch.max(torch.abs(b)), "max"))
    scale_d = 1.0 + float(red(torch.max(torch.abs(cw)), "max"))

    def mu_of(w, zl, zu):
        gaps = torch.where(has_l, (w - l_safe) * zl, zero) \
            + torch.where(has_u, (u_safe - w) * zu, zero)
        return red(torch.sum(gaps), "sum") / n_act

    def residuals(w, y, zl, zu, x):
        rp = torch.einsum("smw,sw->sm", G, w) - b
        rp[:, mc - N:] -= x[None, :]
        rd = cw + qw * w - torch.einsum("smw,sm->sw", G, y) - zl + zu
        rx = red(torch.sum(y[:, mc - N:], dim=0), "sum")
        return rp, rd, rx

    def max_step(v, dv, mask):
        r = torch.where(mask & (dv < 0.0),
                        -v / torch.clamp(dv, max=-1e-30),
                        torch.full_like(v, float("inf")))
        return min(1.0, opts.frac_to_bound * float(red(torch.min(r),
                                                        "min")))

    done = False
    best = None
    best_score = float("inf")
    best_mu = best_resid = float("inf")
    for _ in range(opts.max_iter):
        rp, rd, rx = residuals(w, y, zl, zu, x)
        mu = mu_of(w, zl, zu)
        dl = torch.where(has_l, torch.clamp(w - l_safe, min=floor),
                         torch.ones_like(w))
        du = torch.where(has_u, torch.clamp(u_safe - w, min=floor),
                         torch.ones_like(w))
        D = qw + torch.where(has_l, zl / dl, zero) \
            + torch.where(has_u, zu / du, zero) \
            + torch.finfo(dt).tiny ** 0.5
        Dinv = 1.0 / D
        GD = G * Dinv[:, None, :]
        M = torch.einsum("smw,skw->smk", GD, G)
        # a relative jitter keeps the Cholesky stable as the barrier
        # spreads the diagonal; refinement against the TRUE M removes
        # its bias
        diag_scale = torch.clamp(
            torch.diagonal(M, dim1=1, dim2=2).abs().amax(-1, keepdim=True),
            min=1e-12)[..., None]
        L = torch.linalg.cholesky(M + 50.0 * eps * diag_scale * eye_mc)

        def msolve(r):
            rr = r if r.ndim == 3 else r[..., None]

            def base(v):
                zz = torch.linalg.solve_triangular(L, v, upper=False)
                return torch.linalg.solve_triangular(L.mT, zz, upper=True)

            u0 = base(rr)
            for _ in range(2):
                u0 = u0 + base(rr - M @ u0)
            return u0 if r.ndim == 3 else u0[..., 0]

        # P = M^-1 J (S, mc, N); K = sum_s P[last N rows] (neg. def.)
        P = msolve(torch.broadcast_to(EJ, (S, mc, N)))
        K = red(torch.sum(P[:, mc - N:, :], dim=0), "sum") \
            - 1e-9 * torch.eye(N, dtype=dt, device=dev)

        def kkt_solve(rl, ru):
            """One Newton solve for complementarity targets rl/ru."""
            rd_hat = rd - torch.where(has_l, rl / dl, zero) \
                + torch.where(has_u, ru / du, zero)
            g = -rp + torch.einsum("smw,sw->sm", GD, rd_hat)
            Mg = msolve(g)
            dx = torch.linalg.solve(K, rx + red(torch.sum(
                Mg[:, mc - N:], dim=0), "sum"))
            dy = Mg - torch.einsum("smn,n->sm", P, dx)
            dw = Dinv * (torch.einsum("smw,sm->sw", G, dy) - rd_hat)
            dzl = torch.where(has_l, (rl - zl * dw) / dl, zero)
            dzu = torch.where(has_u, (ru + zu * dw) / du, zero)
            return dw, dy, dx, dzl, dzu

        # affine predictor: complementarity target 0
        rl_a = torch.where(has_l, -dl * zl, zero)
        ru_a = torch.where(has_u, -du * zu, zero)
        dw_a, _, _, dzl_a, dzu_a = kkt_solve(rl_a, ru_a)
        a_p = min(max_step(dl, dw_a, has_l), max_step(du, -dw_a, has_u))
        a_d = min(max_step(zl, dzl_a, has_l), max_step(zu, dzu_a, has_u))
        mu_aff = mu_of(w + a_p * dw_a, zl + a_d * dzl_a, zu + a_d * dzu_a)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                            0.0, 1.0)

        # corrector: centering + Mehrotra's second-order terms
        rl = torch.where(has_l, sigma * mu - dl * zl - dw_a * dzl_a, zero)
        ru = torch.where(has_u, sigma * mu - du * zu + dw_a * dzu_a, zero)
        dw, dy, dx, dzl, dzu = kkt_solve(rl, ru)
        a_p = min(max_step(dl, dw, has_l), max_step(du, -dw, has_u))
        a_d = min(max_step(zl, dzl, has_l), max_step(zu, dzu, has_u))

        w1 = w + a_p * dw
        # rounding can land a hair outside the box: clip strictly inside
        w1 = torch.where(has_l, torch.maximum(w1, l_safe + floor), w1)
        w1 = torch.where(has_u, torch.minimum(w1, u_safe - floor), w1)
        x1 = x + a_p * dx
        y1 = y + a_d * dy
        zl1 = torch.where(has_l, torch.clamp(zl + a_d * dzl, min=1e-12),
                          zero)
        zu1 = torch.where(has_u, torch.clamp(zu + a_d * dzu, min=1e-12),
                          zero)
        mu1 = float(mu_of(w1, zl1, zu1))
        rp1, rd1, rx1 = residuals(w1, y1, zl1, zu1, x1)
        resid = max(float(red(torch.max(torch.abs(rp1)), "max")) / scale_p,
                    float(red(torch.max(torch.abs(rd1)), "max")) / scale_d,
                    float(torch.max(torch.abs(rx1))) / scale_d)
        finite = bool(red(torch.stack([torch.isfinite(t).all() for t in (
            w1, y1, x1, zl1, zu1)]).all(), "min")) and np.isfinite(mu1)
        if not finite:
            # past the precision floor a step degrades or NaNs: stop on
            # the best point seen
            break
        w, y, zl, zu, x = w1, y1, zl1, zu1, x1
        score = mu1 + resid
        if score < best_score:
            best, best_score = (w, x), score
            best_mu, best_resid = mu1, resid
        if mu1 <= opts.tol and resid <= 100.0 * opts.tol:
            done = True
            break
    if best is None:
        best = (w, x)
    return best[0], best[1], done or best_score <= 101.0 * opts.tol, \
        best_mu, best_resid


class SchurComplement:
    """ref:mpisppy/opt/sc.py:67 — two-stage continuous solves only.  The
    f64 loop runs on the batch's device."""

    def __init__(self, options, batch: ScenarioBatch,
                 scenario_names=None):
        if isinstance(options, dict):
            options = SCOptions(**options)
        self.options = options
        self.batch = batch
        self.scenario_names = scenario_names
        self._s = _structure(batch)

    def solve(self) -> dict:
        s = self._s
        batch = self.batch
        dev = batch.device
        p = _host(batch.p)

        def t(v):
            return torch.as_tensor(np.ascontiguousarray(v),
                                   dtype=torch.float64, device=dev)

        t0 = time.perf_counter()
        w, x, done, mu, resid = _sc_solve(
            t(s["G"]), t(s["b"]), t(s["lw"]), t(s["uw"]), t(s["cw"]),
            t(s["qw"]), t(p), s["N"], self.options, batch)
        # the whole scenario axis's rows (one all-gather on a mesh)
        w, p = batch.scen_host(w, t(p))
        x = _host(x)
        solve_seconds = time.perf_counter() - t0
        # undo the IPM column scaling -> batch (Ruiz) space -> original
        col_s, d_col, c, q = batch.scen_host(*(t(np.broadcast_to(
            v, (batch.num_scenarios, s["n"]))) for v in (
                s["col_s"][:, :s["n"]], _host(batch.d_col),
                _host(batch.qp.c), _host(batch.qp.q))))
        v = w[:, :s["n"]] * col_s
        v_orig = v * d_col
        obj = float((p * (c * v + 0.5 * q * v * v).sum(axis=1)).sum())
        x_orig = x * s["x_row_scale"]
        if self.options.display_progress:
            global_toc(f"SC: mu={mu:.3e} resid={resid:.3e} done={done} "
                       f"obj={obj:.6g}", True)
        return {"objective": obj, "x": x_orig, "v": v_orig,
                "converged": bool(done), "mu": float(mu),
                "resid": float(resid), "backend_used": dev.type,
                "solve_seconds": round(solve_seconds, 4)}
