###############################################################################
# Batched QP over the probability simplex, the FWPH inner QP (port of
# mpisppy_tpu/ops/simplex_qp.py):
#
#     min_{lam in Delta_K}  1/2 lam' H lam + g' lam
#
# with H (S, K, K) PSD Gram matrices (K = the column buffer's size) and a
# per-scenario validity mask on the columns.  Accelerated projected
# gradient (FISTA with gradient-scheme restart); masked columns get
# weight exactly 0 through the projection, so the shapes never change.
# The reference solves one Gurobi QP per scenario
# (ref:mpisppy/fwph/fwph.py:688-775).
###############################################################################
from __future__ import annotations

import functools

import torch

from mpisppy_tpu_torch.scengen.random import normal, prng_key

Tensor = torch.Tensor

_NEG = -1e30  # masked coordinates sort last and never pass the threshold


def project_simplex(v: Tensor, valid: Tensor) -> Tensor:
    """Euclidean projection of each row of v onto the simplex restricted
    to the `valid` columns (invalid coordinates come out exactly 0), by
    sort and threshold."""
    vm = torch.where(valid, v, torch.full_like(v, _NEG))
    u = torch.sort(vm, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - 1.0
    k = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype, device=v.device)
    cond = u - css / k > 0
    # rho = number of active coordinates (>= 1 whenever a column is valid)
    rho = torch.clamp(cond.sum(dim=-1), min=1)
    theta = torch.gather(css, -1, (rho - 1)[..., None]) \
        / rho[..., None].to(v.dtype)
    return torch.where(valid, torch.clamp(vm - theta, min=0.0),
                       torch.zeros_like(v))


@functools.lru_cache(maxsize=8)
def _power_start(shape: tuple) -> Tensor:
    """The power iteration's start vector on the CPU: the JAX package's
    jax.random.normal(PRNGKey(3)) bit for bit (cached by shape)."""
    return normal(prng_key(3), shape)


def _estimate_L(H: Tensor, valid: Tensor, iters: int = 12) -> Tensor:
    """Power-iteration estimate of lambda_max(H) per batch element over
    the valid columns, floored by max |H_ii| (a lower bound for PSD H)
    so a degenerate iterate cannot underestimate."""
    v = _power_start(tuple(H.shape[:-1])).to(dtype=H.dtype, device=H.device)
    v = torch.where(valid, v, torch.zeros_like(v))
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-30)
    lam = torch.ones(H.shape[:-2], dtype=H.dtype, device=H.device)
    for _ in range(iters):
        w = (H @ v[..., None])[..., 0]
        w = torch.where(valid, w, torch.zeros_like(w))
        nrm = torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True),
                          min=1e-30)
        v, lam = w / nrm, nrm[..., 0]
    diag = torch.diagonal(H, dim1=-2, dim2=-1).abs()
    diag_lb = torch.where(valid, diag, torch.zeros_like(diag)).amax(dim=-1)
    return torch.clamp(torch.maximum(lam, diag_lb), min=1e-12)


def solve_simplex_qp(H: Tensor, g: Tensor, valid: Tensor,
                     lam0: Tensor | None = None,
                     iters: int = 200) -> Tensor:
    """FISTA with adaptive (gradient-scheme) restart.

    H: (..., K, K) PSD, g: (..., K), valid: (..., K) bool mask of usable
    columns, lam0: optional warm start (projected first).  Returns
    (..., K) weights on the simplex, zero at invalid columns."""
    L = _estimate_L(H, valid)[..., None]
    if lam0 is None:
        nv = torch.clamp(valid.sum(dim=-1, keepdim=True), min=1)
        lam0 = torch.where(valid, 1.0 / nv.to(g.dtype),
                           torch.zeros_like(g))
    else:
        lam0 = project_simplex(lam0, valid)

    def grad(lam):
        return (H @ lam[..., None])[..., 0] + g

    lam, z = lam0, lam0
    t = torch.ones(g.shape[:-1], dtype=g.dtype, device=g.device)
    for _ in range(iters):
        lam_new = project_simplex(z - grad(z) / L, valid)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        # gradient-scheme restart: momentum pointing uphill resets t
        uphill = torch.sum((z - lam_new) * (lam_new - lam), dim=-1,
                           keepdim=True) > 0
        t_eff = torch.where(uphill[..., 0], torch.ones_like(t_new), t_new)
        beta = torch.where(uphill, torch.zeros_like(uphill, dtype=g.dtype),
                           ((t - 1.0) / t_new)[..., None])
        z = lam_new + beta * (lam_new - lam)
        lam, t = lam_new, t_eff
    return lam
