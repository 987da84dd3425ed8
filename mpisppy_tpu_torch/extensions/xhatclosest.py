###############################################################################
# XhatClosest (port of mpisppy_tpu/extensions/xhatclosest.py;
# ref:mpisppy/extensions/xhatclosest.py:16-117): try the scenario whose
# nonant vector is closest to x̄ — distance the truncated z-score
# sum_slots min(3, |x_s - x̄| / stdev) — as the incumbent candidate x̂.
#
# The distance is one (S, N) reduction on the device and the argmin one
# host read.  The variance comes from the current iterate (node average
# of x^2), so the extension works whether or not compute_xsqbar is on.
# The evaluation is algos.xhat.evaluate (with its stalled-tail rescue):
# on a dense shared A its fixed-nonant solve runs in the window kernel.
###############################################################################
from __future__ import annotations

import torch

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.algos import xhat as xhat_mod
from mpisppy_tpu_torch.core.batch import concretize
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.ops import pdhg


class XhatClosest(Extension):
    """Closest-scenario-to-x̄ incumbent candidate.

    Options through the constructor: functools.partial(XhatClosest,
    options={"keep_solution": bool, "verbose": bool}).  With
    keep_solution=True (the default) the winning x̂ and its objective
    stay on the PH object as `_xhat_closest_xhat` / `_final_xhat_closest_obj`.
    """

    def __init__(self, ph, options: dict | None = None):
        super().__init__(ph)
        self.options = dict(options or {})
        self.keep_solution = bool(self.options.get("keep_solution", True))
        self._final_xhat_closest_obj = None

    # -- the distance and the pick (ref:xhatclosest.py:29-94) --------------
    def closest_scenario(self) -> int:
        st = self.opt.state
        batch = self.opt.batch
        x_non = batch.nonants(st.solver.x)              # (S, N)
        xbar = st.xbar                                  # (S, N)
        xsqbar, _ = batch.node_average(x_non * x_non)
        var = xsqbar - xbar * xbar
        stdev = torch.sqrt(torch.clamp(var, min=0.0))
        # slots with no spread contribute 0 (the reference's
        # `if variance > 0` guard)
        z = torch.where(var > 1e-12,
                        torch.clamp((x_non - xbar).abs()
                                    / torch.clamp(stdev, min=1e-12),
                                    max=3.0),
                        0.0)
        dist = z.sum(dim=-1)                            # (S,)
        # padded (probability-0) scenarios can never win; the global
        # first-index argmin on a sharded batch
        dist = torch.where(batch.p > 0.0, dist, float("inf"))
        return batch.scen_argmax(-dist)

    def xhat_closest_to_xbar(self, verbose: bool = False):
        """Returns (obj or None if infeasible, {"ROOT": winning scenario
        name}), the surface of ref:xhatclosest.py:29."""
        sidx = self.closest_scenario()
        batch = concretize(self.opt.batch)
        x_non = batch.nonants(self.opt.state.solver.x)
        cand = xhat_mod.round_integers(batch, batch.scen_row(x_non, sidx))
        res = xhat_mod.evaluate(batch, cand,
                                getattr(self.opt.options, "pdhg",
                                        pdhg.PDHGOptions()))
        feasible = bool(res.feasible)
        obj = float(res.value) if feasible else None
        sname = self.opt.scenario_names[sidx] \
            if sidx < len(self.opt.scenario_names) else f"scen{sidx}"
        if verbose:
            global_toc(f"XhatClosest: scenario {sname} -> "
                       f"{obj if feasible else 'infeasible'}", True)
        if feasible and self.keep_solution:
            self.opt._xhat_closest_xhat = cand.cpu().numpy()
        return obj, {"ROOT": sname}

    # -- hooks (the reference fires at post_everything) --------------------
    def post_everything(self):
        obj, _ = self.xhat_closest_to_xbar(
            verbose=bool(self.options.get("verbose", False)))
        self._final_xhat_closest_obj = obj
        self.opt._final_xhat_closest_obj = obj
