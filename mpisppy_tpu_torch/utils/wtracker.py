###############################################################################
# WTracker: W-oscillation diagnostics over a moving window (port of
# mpisppy_tpu/utils/wtracker.py; ref:mpisppy/utils/wtracker.py:15-253).
# Collects the (S, N) W tensor once per PH iteration (one host read) and
# reports per-(scenario, slot) mean/stdev over the last `window`
# iterations: the reference's wlen/reportlen semantics.
###############################################################################
from __future__ import annotations

import collections

import numpy as np

from mpisppy_tpu_torch.telemetry import console
from mpisppy_tpu_torch.utils.atomic_io import atomic_write_text


class WTracker:
    """ref:mpisppy/utils/wtracker.py:15."""

    def __init__(self, ph, window: int = 10):
        self.ph = ph
        self.window = int(window)
        self._hist: collections.deque = collections.deque(maxlen=window)

    def grab_local_Ws(self):
        """Record this iteration's W (ref:wtracker.py grab_local_Ws)."""
        self._hist.append(self.ph.state.W.cpu().numpy())

    def compute_moving_stats(self):
        """(mean, stdev) arrays of shape (S, N) over the window."""
        if not self._hist:
            raise RuntimeError("no W history recorded")
        stack = np.stack(self._hist)
        return stack.mean(axis=0), stack.std(axis=0)

    def report_by_moving_stats(self, stdevthresh: float | None = None):
        """Rows (scenario, slot, mean, stdev) whose stdev exceeds the
        threshold (ref:wtracker.py report_by_moving_stats)."""
        mean, std = self.compute_moving_stats()
        thresh = 0.0 if stdevthresh is None else stdevthresh
        return [(int(s), int(i), float(mean[s, i]), float(std[s, i]))
                for s, i in zip(*np.nonzero(std > thresh))]

    def write_csv(self, fname: str):
        mean, std = self.compute_moving_stats()
        lines = ["scenario,slot,mean,stdev"]
        S, N = mean.shape
        for s in range(S):
            for i in range(N):
                lines.append(f"{s},{i},{mean[s, i]},{std[s, i]}")
        atomic_write_text(fname, "\n".join(lines) + "\n")


class WTrackerExtension:
    """Extension wrapper (ref:mpisppy/extensions/wtracker_extension.py:
    15).  Build with functools.partial(WTrackerExtension, window=...)."""

    def __init__(self, ph, window: int = 10, report_thresh: float = 0.0):
        self.opt = ph
        self.tracker = WTracker(ph, window)
        self.report_thresh = report_thresh

    def pre_iter0(self):
        pass

    def post_iter0(self):
        pass

    def miditer(self):
        pass

    def enditer(self):
        self.tracker.grab_local_Ws()

    def post_everything(self):
        rows = self.tracker.report_by_moving_stats(self.report_thresh)
        # DEBUG level: shown at --telemetry-verbosity 2
        console.log(f"WTracker: {len(rows)} (scenario, slot) pairs above "
                    f"stdev {self.report_thresh}", level=console.DEBUG)
