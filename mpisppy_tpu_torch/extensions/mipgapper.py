###############################################################################
# Gapper (port of mpisppy_tpu/extensions/mipgapper.py;
# ref:mpisppy/extensions/mipgapper.py:16-62): a per-iteration
# solver-effort schedule.  The reference tightens the subproblem MIP gap
# as PH progresses; here "solver effort" is the PDHG window budget per PH
# iteration, so the schedule maps PH iteration -> subproblem_windows.
###############################################################################
from __future__ import annotations

import dataclasses

from mpisppy_tpu_torch.extensions.extension import Extension


class Gapper(Extension):
    """schedule: {iteration: subproblem_windows}; read from
    ph.options.mipgapdict when present."""

    def __init__(self, ph, schedule: dict | None = None):
        super().__init__(ph)
        self.schedule = dict(schedule
                             or getattr(ph.options, "mipgapdict", None)
                             or {})

    def miditer(self):
        k = self.opt._iter
        if k in self.schedule:
            self.opt.options = dataclasses.replace(
                self.opt.options,
                subproblem_windows=int(self.schedule[k]))
