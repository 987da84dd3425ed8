###############################################################################
# WXBarWriter / WXBarReader extensions (port of mpisppy_tpu/extensions/
# wxbar_io.py; ref:mpisppy/utils/wxbarwriter.py:41-100,
# wxbarreader.py:42-105).
#
# Writer: W and/or x̄ CSVs at the end of the run (or at every iteration).
# Reader: loads W/x̄ right after Iter0, so PH warm-starts from saved
# duals.  Option names follow the reference's Config group
# (wxbar_read_write_args, ref:config.py:950-975): W_fname, Xbar_fname,
# init_W_fname, init_Xbar_fname.
###############################################################################
from __future__ import annotations

import os

from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.utils import wxbarutils


class WXBarWriter(Extension):
    def __init__(self, ph, W_fname: str | None = None,
                 Xbar_fname: str | None = None,
                 per_iteration: bool = False):
        super().__init__(ph)
        self.W_fname = W_fname
        self.Xbar_fname = Xbar_fname
        self.per_iteration = per_iteration

    def _emit(self, tag: str | None = None):
        def _name(base):
            if tag is None:
                return base
            root, ext = os.path.splitext(base)
            return f"{root}_{tag}{ext}"
        if self.W_fname:
            wxbarutils.write_W_to_file(self.opt, _name(self.W_fname))
        if self.Xbar_fname:
            wxbarutils.write_xbar_to_file(self.opt, _name(self.Xbar_fname))

    def enditer(self):
        if self.per_iteration:
            self._emit(tag=str(self.opt._iter))

    def post_everything(self):
        self._emit()


class WXBarReader(Extension):
    def __init__(self, ph, init_W_fname: str | None = None,
                 init_Xbar_fname: str | None = None,
                 disable_check: bool = False):
        super().__init__(ph)
        self.init_W_fname = init_W_fname
        self.init_Xbar_fname = init_Xbar_fname
        self.disable_check = disable_check

    def post_iter0(self):
        # after Iter0 the state exists; the loaded values replace the
        # fresh-start W/x̄ (ref:wxbarreader.py:83-97)
        if self.init_W_fname:
            wxbarutils.set_W_from_file(self.init_W_fname, self.opt,
                                       disable_check=self.disable_check)
        if self.init_Xbar_fname:
            wxbarutils.set_xbar_from_file(self.init_Xbar_fname, self.opt)
