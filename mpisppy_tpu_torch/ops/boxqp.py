###############################################################################
# BoxQP: the canonical subproblem form (port of mpisppy_tpu/ops/boxqp.py).
#
#     min   c'x + 1/2 x' diag(q) x
#     s.t.  bl <= A x <= bu          (two-sided row constraints)
#           l  <=   x <= u           (box)
#
# Equality rows are bl == bu; one-sided rows use +/-inf.  An optional
# ConeSpec (ops/cones.py) turns disjoint row blocks into second-order
# cones, (A x - b)_block in K_soc, with the shift b stored in bl and bu.
# A batch of S scenarios adds a leading S axis to every field; a
# deterministic constraint matrix (sslp, ccopf) stays one shared (m, n) A.
# A sparse one (uc) is an ops.sparse.EllMatrix, shared or with batched
# values; its products are gathers in f32 and ignore the precision
# aliases, as in the reference.
#
# Precision: every matvec here is IEEE f32 (TF32 is off, see the package
# __init__).  The iteration-precision aliases only select the arithmetic
# of the PDHG restart-window kernel (ops/pdhg_window.py); restart
# scoring and every certificate run at full f32, as in the reference.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch import resolve_device
from mpisppy_tpu_torch.ops import cones as cones_mod
from mpisppy_tpu_torch.ops.cones import ConeSpec
from mpisppy_tpu_torch.ops.sparse import EllMatrix, ruiz_scale_ell

Tensor = torch.Tensor

#: The precision-alias registry: every alias the JAX package accepts,
#: mapped to the window kernel's arithmetic on Hopper.  "bf16" = one
#: bf16 product per term (hi*hi); "bf16x3" = hi*hi + hi*lo + lo*hi of
#: bf16 splits accumulated in f32; "f32" = IEEE f32 FMA.
PRECISION_ALIASES = {
    "bf16": "bf16",
    "default": "bf16",
    "bf16x3": "bf16x3",
    "high": "bf16x3",
    "bf16x6": "f32",
    "highest": "f32",
    "f32": "f32",
}


def as_precision(p):
    """Alias -> kernel mode ("bf16" / "bf16x3" / "f32") or None.
    Unknown strings raise with the full alias list."""
    if p is None:
        return None
    if not isinstance(p, str):
        raise TypeError(
            f"precision must be None or one of "
            f"{sorted(PRECISION_ALIASES)}; got {p!r}")
    try:
        return PRECISION_ALIASES[p.lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision alias {p!r}; valid aliases: "
            f"{', '.join(sorted(PRECISION_ALIASES))} "
            f"(bf16x3 = 3-product bf16 split iteration matvecs; "
            f"bf16x6/f32 = IEEE f32)") from None


@dataclasses.dataclass(frozen=True)
class BoxQP:
    """One (or, with a leading batch axis, many) box-constrained QP(s).

    Shapes (unbatched): c,q,l,u: (n,); A: (m,n); bl,bu: (m,).  Batched:
    a leading S axis on any field; A may stay (m,n) and broadcast.

    cones: optional ConeSpec partitioning the rows into box rows and
    second-order-cone blocks, shared across the batch.  SOC rows store
    their shift b in both bl and bu.  None is the pure box problem."""

    c: Tensor
    q: Tensor
    A: Tensor | EllMatrix
    bl: Tensor
    bu: Tensor
    l: Tensor  # noqa: E741
    u: Tensor
    cones: ConeSpec | None = None

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.c.device

    def matvec(self, x: Tensor) -> Tensor:
        """A @ x, batch-aware (A may be shared across the batch)."""
        if isinstance(self.A, EllMatrix):
            return self.A.matvec(x)
        if self.A.ndim == x.ndim + 1:
            return (self.A @ x.unsqueeze(-1)).squeeze(-1)
        return x @ self.A.T

    def rmatvec(self, y: Tensor) -> Tensor:
        """A.T @ y, batch-aware."""
        if isinstance(self.A, EllMatrix):
            return self.A.rmatvec(y)
        if self.A.ndim == y.ndim + 1:
            return (y.unsqueeze(-2) @ self.A).squeeze(-2)
        return y @ self.A


def make_boxqp(c, A, bl, bu, l, u, q=None,  # noqa: E741
               device=None, cones: ConeSpec | None = None) -> BoxQP:
    """Build a BoxQP from numpy-ish inputs (f32), defaulting q to zeros.
    Runs on CUDA unless device="cpu" is given; `cones` is checked
    against the bounds (bl == bu on SOC rows) and moved to the device."""
    dev = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    if cones is not None:
        cones_mod.validate_against_bounds(cones, bl, bu)
        cones = cones.to(dev)
    c = t(c)
    return BoxQP(c=c, q=torch.zeros_like(c) if q is None else t(q),
                 A=t(A), bl=t(bl), bu=t(bu), l=t(l), u=t(u), cones=cones)


def objective(p: BoxQP, x: Tensor) -> Tensor:
    """c'x + 1/2 x'diag(q)x (sums over the trailing axis only)."""
    return torch.sum(p.c * x + 0.5 * p.q * x * x, dim=-1)


def _finite_or_zero(v: Tensor) -> Tensor:
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def dual_objective(p: BoxQP, x: Tensor, y: Tensor) -> Tensor:
    """Fenchel dual value at (y, reduced costs), using x for the Q term;
    contributions of infinite bounds against adverse signs are excluded
    (PDLP-style accounting: they show up in the dual residual)."""
    rc = p.c + p.q * x + p.rmatvec(y)
    ycontrib = _finite_or_zero(torch.where(y > 0.0, p.bu * y, p.bl * y))
    rccontrib = _finite_or_zero(torch.where(rc > 0.0, p.l * rc, p.u * rc))
    quad = 0.5 * torch.sum(p.q * x * x, dim=-1)
    return -quad - torch.sum(ycontrib, dim=-1) + torch.sum(rccontrib, dim=-1)


def primal_residual(p: BoxQP, x: Tensor) -> Tensor:
    """Per-row distance of Ax from the row set: [bl, bu] on box rows,
    the shifted cone b + K on SOC blocks (rowwise |ax - Proj(ax)|);
    0 when feasible."""
    ax = p.matvec(x)
    r = torch.clamp(ax - p.bu, min=0.0) + torch.clamp(p.bl - ax, min=0.0)
    if p.cones is not None:
        soc = cones_mod.primal_violation_rows(p.cones, ax, p.bl)
        r = torch.where(p.cones.is_soc, soc, r)
    return r


def dual_residual(p: BoxQP, x: Tensor, y: Tensor) -> Tensor:
    """Per-column dual infeasibility: rc_i > 0 is certified by a finite
    lower bound, rc_i < 0 by a finite upper bound (PDLP convention)."""
    rc = p.c + p.q * x + p.rmatvec(y)
    zero = torch.zeros_like(rc)
    res_pos = torch.where(torch.isfinite(p.l), zero, torch.clamp(rc, min=0.0))
    res_neg = torch.where(torch.isfinite(p.u), zero,
                          torch.clamp(-rc, min=0.0))
    return res_pos + res_neg


def kkt_residuals(p: BoxQP, x: Tensor, y: Tensor):
    """(rel_primal, rel_dual, rel_gap) — relative inf-norm KKT residuals.
    Conic problems fold the distance of each dual SOC block to the polar
    cone into rel_dual, so every certificate gate downstream refuses a
    bound whose conic Fenchel accounting has not converged."""
    rp = primal_residual(p, x).abs().amax(dim=-1)
    rd = dual_residual(p, x, y).abs().amax(dim=-1)
    if p.cones is not None:
        rd = torch.maximum(rd, cones_mod.dual_cone_residual_rows(
            p.cones, y).amax(dim=-1))
    b_scale = torch.maximum(_finite_or_zero(p.bl).abs(),
                            _finite_or_zero(p.bu).abs())
    c_scale = p.c.abs().amax(dim=-1)
    pobj = objective(p, x)
    dobj = dual_objective(p, x, y)
    rel_p = rp / (1.0 + b_scale.amax(dim=-1))
    rel_d = rd / (1.0 + c_scale)
    rel_g = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
    return rel_p, rel_d, rel_g


# --------------------------------------------------------------------------
# Infeasibility / unboundedness certificates (per batch element).
# --------------------------------------------------------------------------
def infeasibility_certificate(p: BoxQP, y: Tensor, tol: float = 1e-6):
    """True where `y` certifies primal infeasibility (Farkas):
    q(y) = inf_{l<=x<=u} (A'y)'x - sup_{bl<=v<=bu} y'v > 0, tested on the
    l1-normalized y against a scale-aware threshold.  On SOC blocks the
    sup is b'y only for y in the polar cone, so y is projected there
    first (box rows pass through)."""
    if p.cones is not None:
        y = cones_mod.project_polar_rows(p.cones, y)
    nrm = y.abs().sum(dim=-1, keepdim=True)
    yn = y / torch.clamp(nrm, min=1e-30)
    z = p.rmatvec(yn)
    # entries below the f32 rounding floor of A'y count as zero; their
    # potential contribution is added back into the threshold
    ztol = 32.0 * torch.finfo(z.dtype).eps
    drop = z.abs() <= ztol
    z = torch.where(drop, torch.zeros_like(z), z)
    inf_j = torch.where(z > 0.0, z * p.l, z * p.u)
    inf_j = torch.where(z == 0.0, torch.zeros_like(inf_j), inf_j)
    sup_i = torch.where(yn > 0.0, yn * p.bu, yn * p.bl)
    sup_i = torch.where(yn == 0.0, torch.zeros_like(sup_i), sup_i)
    bad = (~torch.isfinite(inf_j)).any(dim=-1) \
        | (~torch.isfinite(sup_i)).any(dim=-1)
    qval = inf_j.sum(dim=-1) - sup_i.sum(dim=-1)
    absl = _finite_or_zero(p.l).abs()
    absu = _finite_or_zero(p.u).abs()
    dropped_err = torch.where(drop, ztol * torch.maximum(absl, absu),
                              torch.zeros_like(z)).sum(dim=-1)
    scale = 1.0 + inf_j.abs().sum(dim=-1) + sup_i.abs().sum(dim=-1)
    return ~bad & (qval > tol * scale + dropped_err) & (nrm[..., 0] > 1e-30)


def unboundedness_certificate(p: BoxQP, d: Tensor, tol: float = 1e-6):
    """True where direction `d` certifies an unbounded objective: a
    recession direction of the feasible set with c'd < 0 (cost-scale
    relative) and no curvature along d."""
    nrm = d.abs().sum(dim=-1, keepdim=True)
    dn = d / torch.clamp(nrm, min=1e-30)
    ad = p.matvec(dn)
    row_ok = torch.where(torch.isfinite(p.bu), ad <= tol, True) \
        & torch.where(torch.isfinite(p.bl), ad >= -tol, True)
    if p.cones is not None:
        # the recession cone of b + K is K itself: the direction's block
        # must lie in the cone, not vanish
        soc_dist = (ad - cones_mod.project_soc_rows(p.cones, ad)).abs()
        row_ok = torch.where(p.cones.is_soc, soc_dist <= tol, row_ok)
    ok_rows = row_ok.all(dim=-1)
    ok_box = (torch.where(torch.isfinite(p.u), dn <= tol, True)
              & torch.where(torch.isfinite(p.l), dn >= -tol, True)
              ).all(dim=-1)
    no_curv = torch.sum(p.q * dn * dn, dim=-1) <= tol
    cscale = 1.0 + p.c.abs().amax(dim=-1)
    descent = torch.sum(p.c * dn, dim=-1) < -tol * cscale
    return ok_rows & ok_box & no_curv & descent & (nrm[..., 0] > 1e-30)


# --------------------------------------------------------------------------
# Ruiz equilibration, in numpy f64 at problem-build time.  The input
# values are the f32 problem's, and the scaled arrays are cast back to
# f32 — the JAX package's cast order, so both builds match bit for bit.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scaling:
    """x_orig = d_col * x_scaled ; y_orig = d_row * y_scaled."""

    d_row: np.ndarray
    d_col: np.ndarray


def group_row_scales(rmax: np.ndarray, cones: ConeSpec | None):
    """Force row scale factors UNIFORM within each SOC block (the block
    max): per-row scaling of a block breaks ||z|| <= t unless it is a
    multiple of the identity on the block, while a shared scale maps
    b + K to (d b) + K exactly.  Box rows keep their own scale.
    rmax: (..., m) positive row maxima."""
    if cones is None:
        return rmax
    seg = cones.seg.cpu().numpy()
    is_soc = cones.is_soc.cpu().numpy()
    C = cones.num_cones + 1
    m = rmax.shape[-1]
    bshape = rmax.shape[:-1]
    B = int(np.prod(bshape)) if bshape else 1
    flat = rmax.reshape(B, m)
    blk = np.zeros((B, C), flat.dtype)
    np.maximum.at(blk, (np.repeat(np.arange(B), m), np.tile(seg, B)),
                  flat.reshape(-1))
    grouped = np.where(is_soc[None, :], blk[:, seg], flat)
    return grouped.reshape(rmax.shape)


def ruiz_scale(p: BoxQP, iters: int = 10) -> tuple[BoxQP, Scaling]:
    """Iterative row/col inf-norm equilibration of A, applied to the
    whole problem.  Batched A gets per-batch scalings; SOC blocks get
    block-uniform row scales (group_row_scales); an EllMatrix takes the
    ELL form of the loop (ops.sparse.ruiz_scale_ell)."""
    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def t(v):
        return torch.as_tensor(v.astype(np.float32), device=p.device)

    if isinstance(p.A, EllMatrix):
        vals, dr, dc = ruiz_scale_ell(f64(p.A.vals), p.A.cols.cpu().numpy(),
                                      p.A.n, iters, cones=p.cones)
        return _scaled(p, p.A.with_vals(t(vals)), dr, dc, t, f64)
    A = f64(p.A)
    dr = np.ones(A.shape[:-1], A.dtype)
    dc = np.ones(A.shape[:-2] + (A.shape[-1],), A.dtype)
    for _ in range(iters):
        # all-zero rows/cols keep scale 1 (an epsilon floor would
        # compound 1/sqrt(eps) per sweep into an inf scaling)
        rmax = np.max(np.abs(A), axis=-1)
        rmax = np.where(rmax <= 0.0, 1.0, rmax)
        rmax = group_row_scales(rmax, p.cones)
        A = A / np.sqrt(rmax)[..., None]
        dr = dr / np.sqrt(rmax)
        cmax = np.max(np.abs(A), axis=-2)
        cmax = np.where(cmax <= 0.0, 1.0, cmax)
        A = A / np.sqrt(cmax)[..., None, :]
        dc = dc / np.sqrt(cmax)
    return _scaled(p, t(A), dr, dc, t, f64)


def _scaled(p: BoxQP, A, dr, dc, t, f64) -> tuple[BoxQP, Scaling]:
    scaled = BoxQP(
        c=t(f64(p.c) * dc), q=t(f64(p.q) * dc * dc), A=A,
        bl=t(f64(p.bl) * dr), bu=t(f64(p.bu) * dr),
        l=t(f64(p.l) / dc), u=t(f64(p.u) / dc), cones=p.cones)
    return scaled, Scaling(d_row=dr, d_col=dc)

