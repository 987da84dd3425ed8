###############################################################################
# Small shared scenario utilities (port of mpisppy_tpu/utils/sputils.py;
# only what the ported models need).
###############################################################################
from __future__ import annotations

import re

_TRAILING_DIGITS = re.compile(r"(\d+)$")


def extract_num(name: str) -> int:
    """Digits scraped off the right of a scenario name
    (ref:mpisppy/utils/sputils.py:632-689 scenario-number parsing)."""
    m = _TRAILING_DIGITS.search(name)
    if m is None:
        raise ValueError(f"scenario name {name!r} has no trailing number")
    return int(m.group(1))
