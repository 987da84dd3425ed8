###############################################################################
# Cross-scenario cuts (port of mpisppy_tpu/algos/cross_scen.py;
# ref:mpisppy/cylinders/cross_scen_spoke.py:17-303,
# ref:mpisppy/extensions/cross_scen_extension.py:22-433).
#
# A cut spoke picks the hub scenario-x farthest from x̄ and generates
# L-shaped cuts from every scenario's recourse there (one batched
# fixed-nonant solve, algos/lshaped._subproblem_cuts); the hub installs
# them and periodically solves each subproblem with an "EF objective"
# (own costs + the others' etas) for a certified outer bound (char 'C').
#
# Two augmented views of the batch, both with PREALLOCATED cut buffers,
# so an arriving round of cuts is an in-place index write into fixed
# tensors (the JAX package's `.at[].set` on static shapes):
#
#   * PH view (make_meta's aug_ph): cut ROWS only, no eta columns.  An
#     optimality cut is vacuous in a PH subproblem (eta has no cost
#     there) and free zero-cost columns degrade PDHG, so only
#     FEASIBILITY cuts (pure-x Farkas rows) enter the PH subproblems.
#   * EF view (aug_ef): eta columns + ALL cut rows, used only by the
#     periodic bound check.  Subproblem s pins its OWN eta at its lower
#     bound and deactivates its own optimality-cut rows.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch.core.batch import ScenarioBatch, require_unsharded
from mpisppy_tpu_torch.ops import boxqp, pdhg
from mpisppy_tpu_torch.ops.sparse import EllMatrix

Tensor = torch.Tensor


@dataclasses.dataclass
class CrossScenMeta:
    """Host bookkeeping: both augmented views + the cut registry."""

    n_orig: int
    m_orig: int
    S: int
    max_rounds: int
    eta_lb: np.ndarray              # (S,)
    aug_ph: ScenarioBatch           # rows-only view (feasibility cuts)
    aug_ef: ScenarioBatch           # eta-columns view (all cuts)
    is_opt: np.ndarray              # (R,) slot holds an optimality cut
    rounds_used: int = 0

    @property
    def R(self) -> int:
        return self.max_rounds * self.S


def _extend_cols(x: Tensor, fill: float, width: int) -> Tensor:
    pad = torch.full(x.shape[:-1] + (width,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-1)


def _add_rows(batch: ScenarioBatch, R: int, n_new: int,
              cut_k: int) -> ScenarioBatch:
    """Append R inactive rows (and, for the EF view, n_new eta columns)
    to a batch; a cut row holds `cut_k` nonzeros in ELL form."""
    qp = batch.qp
    n, m = qp.n, qp.m
    dt, dev = qp.c.dtype, qp.device
    S, N = batch.num_scenarios, batch.num_nonants

    def cols(t, fill):
        return _extend_cols(t, fill, n_new) if n_new else t

    c, q = cols(qp.c, 0.0), cols(qp.q, 0.0)
    l, u = cols(qp.l, 0.0), cols(qp.u, float("inf"))  # noqa: E741
    bl = _extend_cols(qp.bl, -float("inf"), R)
    bu = _extend_cols(qp.bu, float("inf"), R)

    if isinstance(qp.A, EllMatrix):
        k_new = max(qp.A.k, cut_k)
        vals, acols = qp.A.vals, qp.A.cols
        if k_new > qp.A.k:
            vals = _extend_cols(vals, 0.0, k_new - qp.A.k)
            acols = torch.cat([acols, torch.zeros(
                (m, k_new - qp.A.k), dtype=acols.dtype, device=dev)], -1)
        # cut-row pattern: the N nonant slots, then (EF view) the round-r
        # scenario-k row's eta column, then padding (column 0)
        pat = [torch.broadcast_to(batch.nonant_idx, (R, N))]
        if n_new:
            pat.append((n + torch.arange(S, device=dev).repeat(R // S))
                       [:, None])
        pat.append(torch.zeros((R, k_new - N - (1 if n_new else 0)),
                               dtype=batch.nonant_idx.dtype, device=dev))
        cut_cols = torch.cat(pat, dim=-1).to(acols.dtype)
        acols = torch.cat([acols, cut_cols], dim=0)
        vals = torch.cat([vals, torch.zeros(vals.shape[:-2] + (R, k_new),
                                            dtype=vals.dtype, device=dev)],
                         dim=-2)
        A = EllMatrix(vals=vals, cols=acols, n=n + n_new)
    else:
        bshape = tuple(qp.A.shape[:-2])
        A = qp.A
        if n_new:
            A = torch.cat([A, torch.zeros(bshape + (m, n_new), dtype=dt,
                                          device=dev)], dim=-1)
        A = torch.cat([A, torch.zeros(bshape + (R, n + n_new), dtype=dt,
                                      device=dev)], dim=-2)

    d_col = cols(batch.d_col, 1.0)
    d_row = _extend_cols(batch.d_row, 1.0, R)
    return dataclasses.replace(
        batch,
        qp=dataclasses.replace(qp, c=c, q=q, A=A, bl=bl, bu=bu, l=l, u=u),
        d_col=d_col, d_row=d_row)


def make_meta(batch: ScenarioBatch, eta_lb: np.ndarray,
              max_rounds: int = 8) -> CrossScenMeta:
    """Build both augmented views
    (ref:cross_scen_extension.py:273-300 post_iter0 analog)."""
    require_unsharded(batch, "cross_scen.make_meta")
    S, N = batch.num_scenarios, batch.num_nonants
    R = max_rounds * S
    aug_ph = _add_rows(batch, R, 0, cut_k=N)
    aug_ef = _add_rows(batch, R, S, cut_k=N + 1)
    l = aug_ef.qp.l.clone()  # noqa: E741
    l[..., batch.qp.n:] = torch.as_tensor(np.asarray(eta_lb),
                                          dtype=l.dtype, device=l.device)
    aug_ef = dataclasses.replace(
        aug_ef, qp=dataclasses.replace(aug_ef.qp, l=l))
    return CrossScenMeta(n_orig=batch.qp.n, m_orig=batch.qp.m, S=S,
                         max_rounds=max_rounds,
                         eta_lb=np.asarray(eta_lb, np.float64),
                         aug_ph=aug_ph, aug_ef=aug_ef,
                         is_opt=np.zeros(R, bool))


def launch_cuts(batch: ScenarioBatch, nonants: Tensor, xbar: Tensor,
                opts: pdhg.PDHGOptions) -> dict:
    """Spoke-side cut generation on the ORIGINAL batch: the scenario x
    farthest from x̄ (ref:cross_scen_spoke.py:190-230, first index on
    ties), every scenario's recourse solved there in one batch."""
    require_unsharded(batch, "cross_scen.launch_cuts")
    from mpisppy_tpu_torch.algos.lshaped import _subproblem_cuts
    nonants = torch.as_tensor(nonants, device=batch.device)
    xbar = torch.as_tensor(xbar, device=batch.device)
    dist = torch.linalg.vector_norm(nonants - xbar, dim=-1)
    dist = torch.where(batch.p > 0.0, dist,
                       torch.full_like(dist, -float("inf")))
    xhat = nonants[int(torch.argmax(dist))]
    return {"xhat": xhat, **_subproblem_cuts(batch, xhat, opts)}


def package_cuts(raw: dict, opts: pdhg.PDHGOptions) -> dict:
    """Host packaging of launch_cuts' results.  Validity gates: a
    feasibility cut needs a FINITE separating Farkas form (qval > tol);
    an optimality cut needs the dual-residual certificate
    (dual_objective overestimates when rd is large).  A scenario passing
    neither is `usable=False` and writes no row."""
    def host(k):
        return raw[k].detach().cpu().numpy()

    tol = np.maximum(opts.certificate_tol, 1e-6)
    feas_const, feas_g = host("feas_const"), host("feas_g")
    infeas = (host("feas_qval") > tol) & np.isfinite(feas_const) \
        & np.isfinite(feas_g).all(axis=-1)
    rdtol = np.maximum(opts.tol, 5.0 * np.finfo(np.float32).eps)
    opt_ok = host("rd") <= 10.0 * rdtol
    return {"xhat": host("xhat"), "infeas": infeas,
            "usable": infeas | opt_ok, "feas_g": feas_g,
            "feas_const": feas_const, "opt_g": host("g"),
            "opt_alpha": host("alpha")}


def _scaled_rows(batch_view: ScenarioBatch, g: np.ndarray,
                 eta_coef: np.ndarray, rhs: np.ndarray):
    """(slot coefficient block, eta coefficients, scaled rhs): cut slopes
    in the scaled column space with one inf-norm equilibration scale per
    cut, shared across subproblems (cut coefficient spreads stall the
    first-order solver otherwise)."""
    nonant_idx = batch_view.nonant_idx.cpu().numpy()
    d_all = batch_view.d_col.cpu().numpy()[..., nonant_idx]
    d_max = d_all if d_all.ndim == 1 else d_all.max(axis=0)
    scale = np.maximum(np.max(np.abs(g) * d_max[None, :], axis=-1),
                       np.abs(eta_coef))
    scale = np.maximum(scale, 1e-8)
    return g / scale[:, None], eta_coef / scale, rhs / scale


def _write_rows(aug: ScenarioBatch, meta: CrossScenMeta, row0: int,
                g: np.ndarray, eta_coef: np.ndarray | None,
                rhs: np.ndarray, active: np.ndarray) -> None:
    """Install S cut rows at row0, in place (inactive entries keep
    bu = +inf)."""
    qp = aug.qp
    dt, dev = qp.c.dtype, qp.device
    S, N = meta.S, g.shape[-1]
    nonant_idx = aug.nonant_idx.cpu().numpy()
    d_col = aug.d_col.cpu().numpy()
    has_eta = eta_coef is not None

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=dev)

    rows = slice(row0, row0 + S)
    if isinstance(qp.A, EllMatrix):
        vals = qp.A.vals
        d_slots = d_col[..., nonant_idx]
        if vals.ndim == 2:
            row_vals = g * d_slots[None, :]
        else:
            row_vals = g[None, :, :] * d_slots[:, None, :]
        blocks = [row_vals]
        if has_eta:
            blocks.append(np.broadcast_to(eta_coef[:, None],
                                          row_vals.shape[:-1] + (1,)))
        blocks.append(np.zeros(row_vals.shape[:-1]
                               + (qp.A.k - N - int(has_eta),)))
        vals[..., rows, :] = t(np.concatenate(blocks, -1))
    else:
        A = qp.A
        d_slots = np.broadcast_to(d_col[..., nonant_idx],
                                  A.shape[:-2] + (len(nonant_idx),))
        new = np.zeros(A.shape[:-2] + (S, A.shape[-1]))
        new[..., nonant_idx] = g * d_slots[..., None, :]
        if has_eta:
            new[..., np.arange(S), meta.n_orig + np.arange(S)] = eta_coef
        A[..., rows, :] = t(new)
    qp.bu[..., rows] = t(np.where(active, rhs, np.inf))


def write_cuts(meta: CrossScenMeta, package: dict) -> None:
    """Install one round of cuts into BOTH views (the fixed-shape analog
    of ref:cross_scen_extension.py:157-243 make_cuts):
      PH view:  feasibility rows only          g·x <= -const
      EF view:  feasibility rows + opt rows    g·x - eta_k <= -alpha_k
    A full buffer overwrites the OLDEST round (a ring)."""
    r = meta.rounds_used % meta.max_rounds
    S = meta.S
    row0 = meta.m_orig + r * S
    infeas = package["infeas"]
    usable = package.get("usable", np.ones(S, bool))
    g = np.where(infeas[:, None], package["feas_g"], package["opt_g"])
    g = np.where(usable[:, None], g, 0.0)
    rhs = np.where(infeas, -package["feas_const"], -package["opt_alpha"])
    rhs = np.where(usable, rhs, np.inf)
    eta_coef = np.where(infeas, 0.0, -1.0)

    # the PH view holds ONLY feasibility rows: optimality-cut slopes must
    # not even occupy its inactive rows (they would inflate the PH
    # subproblems' operator norm)
    feas = infeas & usable
    g_ph, _, rhs_ph = _scaled_rows(
        meta.aug_ph, np.where(feas[:, None], g, 0.0),
        np.zeros_like(eta_coef), np.where(feas, rhs, np.inf))
    _write_rows(meta.aug_ph, meta, row0, g_ph, None, rhs_ph, active=feas)
    g_ef, eta_ef, rhs_ef = _scaled_rows(meta.aug_ef, g, eta_coef, rhs)
    _write_rows(meta.aug_ef, meta, row0, g_ef, eta_ef, rhs_ef,
                active=usable)
    meta.is_opt[row0 - meta.m_orig:row0 - meta.m_orig + S] = \
        ~infeas & usable
    meta.rounds_used += 1


def _ef_bound_qp(aug: ScenarioBatch, owner: Tensor, is_opt: Tensor,
                 eta_lb: Tensor, n_orig: int) -> boxqp.BoxQP:
    """The batch of EF-objective problems on the eta view: subproblem s
    minimizes p_s f_s + sum_{k != s} p_k eta_k under its constraints and
    the cuts, its OWN eta pinned at the lower bound and its own
    optimality-cut rows deactivated."""
    qp = aug.qp
    S = aug.num_scenarios
    dt, dev = qp.c.dtype, qp.device
    p = aug.p
    ar = torch.arange(S, device=dev)
    eta_c = torch.broadcast_to(p[None, :], (S, S)) \
        * (1.0 - torch.eye(S, dtype=dt, device=dev))
    c_ef = torch.cat([torch.broadcast_to(qp.c[..., :n_orig], (S, n_orig))
                      * p[:, None], eta_c], dim=-1)
    u = torch.broadcast_to(qp.u, (S, qp.n)).clone()
    u[ar, n_orig + ar] = eta_lb.to(dt)
    m_orig = qp.m - owner.shape[0]
    bu = torch.broadcast_to(qp.bu, (S, qp.m)).clone()
    own = (owner[None, :] == ar[:, None]) & is_opt[None, :]
    bu[:, m_orig:] = torch.where(own, torch.full_like(own, float("inf"),
                                                      dtype=dt),
                                 bu[:, m_orig:])
    return dataclasses.replace(qp, c=c_ef, u=u, bu=bu)


def _ef_bound_solve(aug: ScenarioBatch, owner: Tensor, is_opt: Tensor,
                    eta_lb: Tensor, n_orig: int, windows: int,
                    opts: pdhg.PDHGOptions, st0: pdhg.PDHGState):
    """Batched solves of _ef_bound_qp's problems.  Certified dual values
    lower-bound the EF optimum; bound = max over certified scenarios
    (ref:cross_scen_extension.py:80-128 _check_bound)."""
    qp_ef = _ef_bound_qp(aug, owner, is_opt, eta_lb, n_orig)
    p = aug.p
    dt = qp_ef.c.dtype
    # the EF relaxation is feasible and bounded below by construction
    opts = dataclasses.replace(opts, detect_infeas=False)
    st = pdhg.solve_fixed(qp_ef, windows, opts, st0)
    dual = boxqp.dual_objective(qp_ef, st.x, st.y)
    _, rd, _ = boxqp.kkt_residuals(qp_ef, st.x, st.y)
    tol = max(opts.tol, 5.0 * torch.finfo(dt).eps)
    ok = (rd <= 10.0 * tol) & (p > 0.0)
    bound = torch.max(torch.where(ok, dual,
                                  torch.full_like(dual, -float("inf"))))
    return bound, st


def ef_check_bound(meta: CrossScenMeta, opts: pdhg.PDHGOptions,
                   windows: int = 400,
                   st0: pdhg.PDHGState | None = None):
    """Returns (bound or None, warm-startable state)."""
    aug = meta.aug_ef
    dev = aug.device
    if st0 is None:
        st0 = pdhg.init_state(aug.qp, opts)
    owner = torch.arange(meta.S, device=dev).repeat(meta.max_rounds)
    bound, st = _ef_bound_solve(
        aug, owner, torch.as_tensor(meta.is_opt, device=dev),
        torch.as_tensor(meta.eta_lb, device=dev), meta.n_orig, windows,
        opts, st0)
    b = float(bound)
    return (b if np.isfinite(b) else None), st


def eta_lower_bounds(batch: ScenarioBatch, opts: pdhg.PDHGOptions,
                     windows: int = 400, margin: float = 0.05
                     ) -> np.ndarray:
    """Valid per-scenario eta lower bounds
    (ref:cross_scen_spoke.py:120-125 set_eta_bounds).  Where the
    wait-and-see dual solve CERTIFIES (rd small), f_k >= that dual value
    minus a safety margin; elsewhere the all-rows-dropped box relaxation
    sum_j min_{x_j in [l,u]} (c_j x_j + q_j/2 x_j^2), always valid,
    possibly -inf.  Floored at -1e12 (a -inf pin degenerates the EF
    check's own-eta column)."""
    require_unsharded(batch, "cross_scen.eta_lower_bounds")
    qp = batch.qp
    st = pdhg.solve_fixed(qp, windows, opts, pdhg.init_state(qp, opts))
    dual = boxqp.dual_objective(qp, st.x, st.y).cpu().numpy() \
        .astype(np.float64)
    _, rd, _ = boxqp.kkt_residuals(qp, st.x, st.y)
    tol = max(opts.tol, 5.0 * float(np.finfo(np.float32).eps))
    certified = rd.cpu().numpy() <= 10.0 * tol
    span = max(1.0, float(np.abs(dual).max()))

    S = batch.num_scenarios

    def f64(v):
        return np.broadcast_to(v.cpu().numpy().astype(np.float64),
                               (S, qp.n))

    c, q, l, u = f64(qp.c), f64(qp.q), f64(qp.l), f64(qp.u)  # noqa: E741
    with np.errstate(invalid="ignore"):
        at_l = np.where(np.isfinite(l), c * l + 0.5 * q * l * l, np.inf)
        at_l = np.where(np.isfinite(l), at_l,
                        np.where((c > 0) | (q > 0), -np.inf, 0.0))
        at_u = np.where(np.isfinite(u), c * u + 0.5 * q * u * u, np.inf)
        at_u = np.where(np.isfinite(u), at_u,
                        np.where((c < 0) | (q > 0), -np.inf, 0.0))
        xs = np.where(q > 0, -c / np.where(q > 0, q, 1.0), 0.0)
        interior = (q > 0) & (xs > l) & (xs < u)
        at_s = np.where(interior, c * xs + 0.5 * q * xs * xs, np.inf)
    box_min = np.minimum(np.minimum(at_l, at_u), at_s).sum(axis=-1)
    lb = np.where(certified, dual - margin * span, box_min)
    return np.maximum(lb, -1e12)
