###############################################################################
# Converger ABC (port of mpisppy_tpu/convergers/converger.py;
# ref:mpisppy/convergers/converger.py:24-47): a hub-side object asked
# `is_converged()` once per PH iteration, with access to the PH object
# (`self.opt`) and thus its PHState.
###############################################################################
from __future__ import annotations

import abc


class Converger(abc.ABC):
    """ref:mpisppy/convergers/converger.py:24."""

    def __init__(self, opt):
        self.opt = opt
        self.conv_value: float | None = None

    @abc.abstractmethod
    def is_converged(self) -> bool:
        ...
