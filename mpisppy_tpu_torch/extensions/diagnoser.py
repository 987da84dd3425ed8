###############################################################################
# Diagnoser (port of mpisppy_tpu/extensions/diagnoser.py;
# ref:mpisppy/extensions/diagnoser.py:21-86): one diagnostic line per
# scenario per iteration in `<diagnoser_outdir>/<scenario>.dag`,
# "iter,objective".  The (S,) per-scenario objective vector comes to the
# host in one read per iteration; rows are buffered and flushed every
# `flush_period` iterations and at the end.  Like the reference it
# refuses to write into an existing directory (it raises where the
# reference quits).
###############################################################################
from __future__ import annotations

import os

from mpisppy_tpu_torch.core.batch import is_root
from mpisppy_tpu_torch.extensions.extension import Extension


class Diagnoser(Extension):
    """Options through the constructor: functools.partial(Diagnoser,
    options={"diagnoser_outdir": path, "flush_period": N}) (PHOptions is
    a frozen dataclass, so the kwarg is the options channel)."""

    def __init__(self, ph, options: dict | None = None):
        super().__init__(ph)
        opts = dict(options or {})
        self.dirname = opts.get("diagnoser_outdir", "diagnostics")
        self.flush_period = int(opts.get("flush_period", 20))
        self._since_flush = 0
        # on a sharded batch every rank gathers the whole axis's
        # objectives; rank 0 writes them
        self._writer = is_root(ph.batch)
        self._rows: dict[str, list[str]] = {}
        if not self._writer:
            return
        if os.path.exists(self.dirname):
            raise RuntimeError(
                f"Diagnoser: output directory exists: {self.dirname} "
                "(refusing to clobber, ref:diagnoser.py:29-34)")
        os.makedirs(self.dirname)

    def write_loop(self):
        st = self.opt.state
        if st is None:
            return
        objs = self.opt.batch.scen_host(
            self.opt.batch.objective(st.solver.x))
        if not self._writer:
            return
        it = self.opt._iter
        for i, name in enumerate(self.opt.scenario_names):
            self._rows.setdefault(name, []).append(f"{it},{objs[i]}\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_period:
            self._flush()

    def _flush(self):
        if not self._writer:
            return
        for name, rows in self._rows.items():
            with open(os.path.join(self.dirname, f"{name}.dag"), "a") as f:
                f.writelines(rows)
        self._rows.clear()
        self._since_flush = 0

    def post_iter0(self):
        self.write_loop()

    def enditer(self):
        self.write_loop()

    def post_everything(self):
        self._flush()
