# W-oscillation diagnostics as a PH extension (port of
# mpisppy_tpu/extensions/wtracker_extension.py): the import path of
# ref:mpisppy/extensions/wtracker_extension.py:15; the implementation
# lives with its WTracker in utils/wtracker.py.
from mpisppy_tpu_torch.utils.wtracker import WTracker, WTrackerExtension

__all__ = ["WTracker", "WTrackerExtension", "Wtracker_extension"]

Wtracker_extension = WTrackerExtension  # reference class-name spelling
