###############################################################################
# Small shared scenario utilities (port of mpisppy_tpu/utils/sputils.py;
# only what the ported models and the admm wrappers need).
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


def remap_spec_arrays(spec, colmap, n_new: int, m_max: int,
                      scale: float = 1.0) -> dict:
    """Re-lay a ScenarioSpec's arrays into a wider shared layout.

    colmap[j] = new column of old column j.  Unused new columns are
    fixed at 0 (dummy vars, ref:mpisppy/utils/admmWrapper.py:129-141);
    rows are padded inactive up to m_max; c and q are multiplied by
    `scale` (the admm region-count factor).  Shared by the admm
    wrappers (utils/admmWrapper.py, utils/stoch_admmWrapper.py)."""
    import numpy as np
    import scipy.sparse as sps

    c = np.zeros(n_new)
    q = np.zeros(n_new)
    l = np.zeros(n_new)  # noqa: E741
    u = np.zeros(n_new)
    integer = np.zeros(n_new, bool)
    c[colmap] = scale * np.asarray(spec.c)
    if spec.q is not None:
        q[colmap] = scale * np.asarray(spec.q)
    l[colmap] = np.asarray(spec.l)
    u[colmap] = np.asarray(spec.u)
    if spec.integer is not None:
        integer[colmap] = np.asarray(spec.integer, bool)
    used = np.zeros(n_new, bool)
    used[colmap] = True
    l[~used] = 0.0
    u[~used] = 0.0

    A = spec.A if sps.issparse(spec.A) \
        else sps.csr_matrix(np.asarray(spec.A))
    A = A.tocoo()
    m_old = A.shape[0]
    A_new = sps.coo_matrix((A.data, (A.row, colmap[A.col])),
                           shape=(m_max, n_new)).tocsr()
    bl = np.concatenate([np.asarray(spec.bl),
                         np.full(m_max - m_old, -np.inf)])
    bu = np.concatenate([np.asarray(spec.bu),
                         np.full(m_max - m_old, np.inf)])
    return dict(c=c, q=q if q.any() else None, A=A_new, bl=bl, bu=bu,
                l=l, u=u, integer=integer if integer.any() else None)
