###############################################################################
# PHTracker: per-iteration tracking of convergence, bounds, gaps,
# nonants, duals, x̄ and per-scenario solve quality, with optional plots
# (port of mpisppy_tpu/extensions/phtracker.py; ref:mpisppy/extensions/
# phtracker.py:22-580: TrackedData buffers, one csv per quantity, plot_*
# helpers, per-cylinder folders).
#
# Each tensor track reads its tensor to the host once per tracked
# iteration; "scenario gap" is the per-scenario relative KKT score of the
# batched subproblem solve.  Hub scalars (bounds, gaps) come off the
# hub's telemetry bus, from the same hub-iteration events as the JSONL
# trace.
#
# Options (ctor kwargs, or a ph.options.phtracker_options dict which
# overrides them, as in the reference):
#   track_{convergence,gaps,bounds,nonants,duals,xbars,scen_gaps}
#   plot_{...} (matching plot flag per quantity), plots (default all)
#   save_every, write_every, results_folder, cylinder_name
###############################################################################
from __future__ import annotations

import os

from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.core.batch import is_root
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.utils import atomic_io


class TrackedData:
    """Buffered rows -> csv (ref:phtracker.py:22-101 TrackedData).

    The first flush lands header and rows atomically (tmp + rename), later
    flushes append each batch of rows in one write; every buffered row
    lands on the final flush whatever the cadence."""

    def __init__(self, name: str, folder: str, plot: bool = False):
        self.name = name
        self.fname = os.path.join(folder, f"{name}.csv")
        self.plot_fname = os.path.join(folder, f"{name}.png")
        self.plot = plot
        self.columns: list[str] | None = None
        self.rows: list[list] = []          # buffered, not yet on disk
        self._wrote_header = False
        self.write = True   # False on all but one rank of a mesh

    def initialize_df(self, columns):
        self.columns = list(columns)

    def add_row(self, row):
        self.rows.append(list(row))

    def write_out_data(self):
        if self.columns is None or not self.write:
            return
        lines = [",".join(repr(v) if isinstance(v, float) else str(v)
                          for v in r) for r in self.rows]
        self.rows.clear()
        if not self._wrote_header:
            header = ",".join(map(str, self.columns))
            atomic_io.atomic_write_text(
                self.fname, "\n".join([header] + lines) + "\n")
            self._wrote_header = True
        elif lines:
            atomic_io.append_text(self.fname, "\n".join(lines) + "\n")


class PHTracker(Extension):
    _TENSOR_TRACKS = ("nonants", "duals", "xbars", "scen_gaps")
    _SCALAR_TRACKS = ("convergence", "gaps", "bounds")

    def __init__(self, ph, folder: str | None = None, name: str = "hub",
                 track_nonants: bool = False, track_duals: bool = False,
                 track_xbars: bool = False, track_scen_gaps: bool = False,
                 track_convergence: bool = True, track_gaps: bool = True,
                 track_bounds: bool = True, save_every: int = 1,
                 write_every: int = 3, plots: bool = False):
        super().__init__(ph)
        opts = getattr(ph.options, "phtracker_options", None) or {}
        self.folder = opts.get("results_folder", folder) or "phtracker_out"
        self.name = opts.get("cylinder_name", name)
        self.save_every = max(1, int(opts.get("save_every", save_every)))
        self.write_every = max(1, int(opts.get("write_every",
                                               write_every)))
        cyl_folder = os.path.join(self.folder, self.name)
        # a sharded batch's tracks hold the whole axis; rank 0 writes
        writer = is_root(ph.batch)
        if writer:
            os.makedirs(cyl_folder, exist_ok=True)
        flags = {
            "convergence": track_convergence, "gaps": track_gaps,
            "bounds": track_bounds, "nonants": track_nonants,
            "duals": track_duals, "xbars": track_xbars,
            "scen_gaps": track_scen_gaps,
        }
        self.track_dict: dict[str, TrackedData] = {}
        for t in self._SCALAR_TRACKS + self._TENSOR_TRACKS:
            if opts.get(f"track_{t}", flags[t]):
                self.track_dict[t] = TrackedData(
                    t, cyl_folder, plot=opts.get(f"plot_{t}", plots))
                self.track_dict[t].write = writer
        S = ph.batch.scen_total
        N = ph.batch.num_nonants
        heads = {
            "convergence": ["iteration", "conv"],
            "gaps": ["iteration", "abs_gap", "rel_gap"],
            "bounds": ["iteration", "outer", "inner", "eobj", "trivial"],
            "nonants": ["iteration"] + [f"x{s}_{j}" for s in range(S)
                                        for j in range(N)],
            "duals": ["iteration"] + [f"W{s}_{j}" for s in range(S)
                                      for j in range(N)],
            "xbars": ["iteration"] + [f"xbar{j}" for j in range(N)],
            "scen_gaps": ["iteration"] + [f"scen{s}" for s in range(S)],
        }
        for t, td in self.track_dict.items():
            td.initialize_df(heads[t])
        self._hub_row: dict | None = None
        self._subscribed_bus = None

    # -- data pulls --------------------------------------------------------
    def _ensure_subscribed(self, hub):
        bus = getattr(hub, "telemetry", None)
        if bus is None or bus is self._subscribed_bus:
            return
        tracker = self

        class _HubRowCache(tel.Sink):
            def handle(self, event):
                if event.kind == tel.HUB_ITERATION \
                        and event.run == hub.run_id:
                    tracker._hub_row = dict(event.data)

        bus.subscribe(_HubRowCache())
        self._subscribed_bus = bus

    def _bounds(self):
        sp = self.opt.spcomm
        if sp is None:
            return float("nan"), float("nan"), float("nan"), float("nan")
        self._ensure_subscribed(sp)
        row = self._hub_row
        if row is not None:
            return (row["outer"], row["inner"],
                    row["abs_gap"], row["rel_gap"])
        # no hub-iteration event yet (enditer precedes this iteration's
        # sync): read the bookkeeping directly
        abs_gap, rel_gap = sp.compute_gaps()
        return sp.BestOuterBound, sp.BestInnerBound, abs_gap, rel_gap

    def enditer(self):
        ph = self.opt
        k = ph._iter
        if k % self.save_every:
            return
        conv = ph._read_conv()
        outer, inner, abs_gap, rel_gap = self._bounds()
        td = self.track_dict
        if "convergence" in td:
            td["convergence"].add_row([k, conv])
        if "gaps" in td:
            td["gaps"].add_row([k, abs_gap, rel_gap])
        if "bounds" in td:
            tb = ph.trivial_bound
            td["bounds"].add_row([k, outer, inner, ph.Eobjective(),
                                  float("nan") if tb is None else tb])
        st = ph.state
        if "nonants" in td:
            x = ph.batch.scen_host(ph.batch.nonants(st.solver.x)) \
                .reshape(-1)
            td["nonants"].add_row([k] + x.tolist())
        if "duals" in td:
            td["duals"].add_row(
                [k] + ph.batch.scen_host(st.W).reshape(-1).tolist())
        if "xbars" in td:
            td["xbars"].add_row(
                [k] + st.xbar_nodes[0].cpu().numpy().tolist())
        if "scen_gaps" in td:
            td["scen_gaps"].add_row(
                [k] + ph.batch.scen_host(st.solver.score).tolist())
        if k % (self.save_every * self.write_every) == 0:
            for t in td.values():
                t.write_out_data()

    def post_everything(self):
        for td in self.track_dict.values():
            td.write_out_data()
            if td.plot and td.write:
                self._plot(td)

    # -- plots (ref:phtracker.py:452-530 plot_* helpers) -------------------
    def _plot(self, td: TrackedData):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import pandas as pd
        except Exception:
            return  # plotting is best-effort (the csv is the artifact)
        if not os.path.exists(td.fname):
            return
        df = pd.read_csv(td.fname)
        if df.empty:
            return
        fig, ax = plt.subplots(figsize=(7, 4))
        x = df["iteration"]
        ycols = [c for c in df.columns if c != "iteration"]
        # tensor tracks plot a handful of series, scalar tracks all
        for c in ycols[: 12 if td.name in self._TENSOR_TRACKS else 6]:
            ax.plot(x, df[c], label=c, lw=1)
        ax.set_xlabel("PH iteration")
        ax.set_title(f"{self.name}: {td.name}")
        ax.legend(fontsize=6, ncol=2)
        fig.tight_layout()
        fig.savefig(td.plot_fname, dpi=110)
        plt.close(fig)
