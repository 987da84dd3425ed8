###############################################################################
# ProxApproxManager: outer-approximation cuts for the quadratic prox
# term (a copy of mpisppy_tpu/utils/prox_approx.py, numpy only;
# ref:mpisppy/utils/prox_approx.py:24-216).
#
# The reference needs this because its subproblem solvers may be
# LP-only: the PH prox (rho/2)(x - xbar)^2 is replaced by epigraph
# variables with tangent cuts  t >= x_pt^2 + 2 x_pt (x - x_pt), placed
# on demand with a Newton step toward the violating point
# (ref:prox_approx.py:24-60).  The window kernel solves diagonal QPs
# natively, so the main path never needs these cuts: this module exists
# for API parity and for LP-only backends (ops/simplex_qp-style), and
# its math is tested directly.
###############################################################################
from __future__ import annotations

import numpy as np


def tangent_cut(x_pt: np.ndarray):
    """Underestimator of x^2 at x_pt:  t >= 2 x_pt x - x_pt^2.
    Returns (slope, intercept) with t >= slope*x + intercept."""
    x_pt = np.asarray(x_pt, np.float64)
    return 2.0 * x_pt, -(x_pt * x_pt)


class ProxApproxManager:
    """Per-slot cut collection with the reference's on-demand Newton
    placement (ref:prox_approx.py:24-60): when the epigraph value t
    underestimates x^2 by more than tol, add cuts at the midpointish
    Newton iterates between the violating x and the current support."""

    def __init__(self, num_slots: int, tol: float = 1e-2,
                 max_cuts_per_slot: int = 32):
        self.tol = tol
        self.max_cuts = max_cuts_per_slot
        self.cuts: list[list[tuple[float, float]]] = [
            [] for _ in range(num_slots)]
        # seed with the tangent at 0 (t >= 0 for x^2)
        for cl in self.cuts:
            cl.append((0.0, 0.0))

    def evaluate(self, i: int, x: float) -> float:
        """Current epigraph value max over cuts at x."""
        return max(s * x + b for (s, b) in self.cuts[i])

    def add_cut(self, i: int, x: float) -> int:
        """ref:prox_approx.py add_cut: 0 if no violation, else the
        number of cuts added (Newton placement halves the gap)."""
        t = self.evaluate(i, x)
        viol = x * x - t
        if viol <= self.tol or len(self.cuts[i]) >= self.max_cuts:
            return 0
        # Newton step for g(y) = y^2 + t - 2*y*x (the gap function)
        # lands midway; the reference adds the tangent there AND at the
        # reflected point for symmetry
        y = 0.5 * (x + t / x) if abs(x) > 1e-12 else 0.0
        added = 0
        for pt in (y, 2.0 * x - y):
            s, b = tangent_cut(np.asarray(pt))
            self.cuts[i].append((float(s), float(b)))
            added += 1
        return added

    def check_and_add(self, x_vec: np.ndarray) -> int:
        """Vector interface: one pass over all slots, returns total cuts
        added (0 means the approximation is tol-tight at x_vec)."""
        return sum(self.add_cut(i, float(x))
                   for i, x in enumerate(np.asarray(x_vec)))
