###############################################################################
# Hub side of cross-scenario cuts (port of
# mpisppy_tpu/extensions/cross_scen_extension.py;
# ref:mpisppy/extensions/cross_scen_extension.py:22-433).
#
# At construction it swaps the PH driver's batch for the rows-augmented
# one (a preallocated cut buffer, algos/cross_scen.make_meta); each
# iteration it installs any new cut package from the
# CrossScenarioCutSpoke (in-place writes into the buffer) and
# periodically solves the batched EF objective for a certified outer
# bound (char 'C', ref:cross_scen_extension.py:80-128 _check_bound),
# only when the inner bound has not improved for
# `check_bound_improve_iterations` hub iterations.
###############################################################################
from __future__ import annotations

import dataclasses
import math

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.algos import cross_scen
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.ops import pdhg


class CrossScenarioExtension(Extension):
    def __init__(self, ph, check_bound_improve_iterations: int | None = 4,
                 max_rounds: int = 8,
                 pdhg_opts: pdhg.PDHGOptions | None = None):
        super().__init__(ph)
        if ph.batch.tree.num_nodes != 1:
            raise RuntimeError("CrossScenarioExtension only supports "
                               "two-stage models at this time "
                               "(ref:cross_scen_extension.py:26-28)")
        self.check_bound_iterations = check_bound_improve_iterations
        self.pdhg_opts = pdhg_opts or pdhg.PDHGOptions(tol=1e-7,
                                                       max_iters=100_000)
        # the cut spoke generates cuts on the ORIGINAL batch
        ph._cross_scen_orig_batch = ph.batch
        eta_lb = cross_scen.eta_lower_bounds(ph.batch, self.pdhg_opts)
        self.meta = cross_scen.make_meta(ph.batch, eta_lb,
                                         max_rounds=max_rounds)
        ph.batch = self.meta.aug_ph
        self.any_cuts = False
        self.cur_ib = math.inf
        self.iter_at_cur_ib = 0
        self.iter_since_last_check = 0
        self._ef_warm = None

    def _spoke(self):
        from mpisppy_tpu_torch.cylinders.spoke import CrossScenarioCutSpoke
        spcomm = self.opt.spcomm
        if spcomm is None:
            return None
        for sp in getattr(spcomm, "spokes", []):
            if isinstance(sp, CrossScenarioCutSpoke):
                return sp
        return None

    def _get_cuts(self):
        sp = self._spoke()
        if sp is None or not sp.new_cuts:
            return
        sp.new_cuts = False
        # other extensions (the reduced-costs fixer) may have tightened
        # or collapsed boxes on the live batch: carry them into the PH
        # view BEFORE installing cuts so they are never reverted
        live = self.opt.batch.qp
        self.meta.aug_ph = dataclasses.replace(
            self.meta.aug_ph,
            qp=dataclasses.replace(self.meta.aug_ph.qp, l=live.l,
                                   u=live.u))
        cross_scen.write_cuts(self.meta, sp.cut_package)
        self.opt.batch = self.meta.aug_ph
        self.any_cuts = True
        self._ef_warm = None   # the cuts moved the problem

    def _check_bound(self):
        bound, st = cross_scen.ef_check_bound(
            self.meta, self.pdhg_opts, st0=self._ef_warm)
        self._ef_warm = st
        if bound is not None and self.opt.spcomm is not None:
            self.opt.spcomm.OuterBoundUpdate(bound, "C")
            global_toc(f"cross-scen EF bound: {bound:.6g}",
                       self.opt.options.display_progress)

    def sync_with_spokes(self):
        """The hub's exchange point: pull any fresh cut package off the
        cut spoke and install it (idempotent with the miditer pull)."""
        self._get_cuts()

    def miditer(self):
        self._get_cuts()
        if self.check_bound_iterations is None or not self.any_cuts:
            return
        spcomm = self.opt.spcomm
        ib = spcomm.BestInnerBound if spcomm is not None else math.inf
        if ib != self.cur_ib:
            self.cur_ib = ib
            self.iter_at_cur_ib = self.opt._iter
        self.iter_since_last_check += 1
        stalled = (self.opt._iter - self.iter_at_cur_ib
                   >= self.check_bound_iterations)
        if stalled and \
                self.iter_since_last_check >= self.check_bound_iterations:
            self.iter_since_last_check = 0
            self._check_bound()

    def post_everything(self):
        # one final bound attempt so late cuts count
        self._get_cuts()
        if self.any_cuts and self.check_bound_iterations is not None:
            self._check_bound()

    @property
    def cuts_installed(self) -> int:
        return self.meta.rounds_used * self.meta.S
