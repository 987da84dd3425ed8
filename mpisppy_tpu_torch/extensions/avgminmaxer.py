###############################################################################
# MinMaxAvg (port of mpisppy_tpu/extensions/avgminmaxer.py;
# ref:mpisppy/extensions/avgminmaxer.py:16-44): log avg/min/max (and
# max-min) of a per-scenario component each iteration.  The component is
# a per-scenario device vector; its three reductions come to the host in
# one read.  Component names:
#   "objective"        — per-scenario objective at the current iterate
#   "nonant:<k>"       — nonant slot k's per-scenario value
###############################################################################
from __future__ import annotations

import torch

from mpisppy_tpu_torch.core.batch import mesh_reduce
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.telemetry import console as _console


class MinMaxAvg(Extension):
    def __init__(self, ph, compstr: str | None = None):
        # the component name comes through the constructor
        # (functools.partial(MinMaxAvg, compstr=...))
        super().__init__(ph)
        self.compstr = compstr or "objective"

    def _component(self):
        st = self.opt.state
        batch = self.opt.batch
        if self.compstr.startswith("nonant:"):
            k = int(self.compstr.split(":", 1)[1])
            return batch.nonants(st.solver.x)[:, k]
        return batch.objective(st.solver.x)

    def avg_min_max(self):
        """(avg, min, max) over real scenarios (ref PHBase.avg_min_max)."""
        batch = self.opt.batch
        vals = self._component()
        real = batch.p > 0.0
        avg = batch.expectation(vals)
        vmin = mesh_reduce(batch, torch.where(real, vals, float("inf"))
                           .min(), "min")
        vmax = mesh_reduce(batch, torch.where(real, vals, -float("inf"))
                           .max(), "max")
        out = torch.stack([avg, vmin, vmax]).cpu().numpy()  # one read
        return float(out[0]), float(out[1]), float(out[2])

    def _report(self):
        if self.opt.state is None:
            return
        avgv, minv, maxv = self.avg_min_max()
        _console.log(f"  ###  {self.compstr}: avg, min, max, max-min "
                     f"{avgv} {minv} {maxv} {maxv - minv}")

    def post_iter0(self):
        self._report()

    def enditer(self):
        self._report()
