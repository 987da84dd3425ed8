###############################################################################
# GBD: Ferguson & Dantzig (1956) aircraft allocation under random route
# demand (port of mpisppy_tpu/models/gbd.py; numpy only; ref:mpisppy/tests/examples/gbd/gbd.py; the extended demand
# distributions follow Bayraksan & Morton's sequential-sampling study).
#
# First stage: x_{a,r} aircraft of type a flown on route r (continuous
# nonants; three (a, r) pairs are forbidden and fixed to 0) with
# aircraft-inventory equalities via slack columns.
# Second stage: passenger surplus/deficit slack per route against the
# random demand; deficits cost the route's lost-revenue rate.
#
# Columns (n = 34): [x (20 a-major), acSlack (4), psPos (5), psNeg (5)]
# Rows (m = 9): 4 inventory equalities, 5 demand equalities.
###############################################################################
from __future__ import annotations

import json

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num

_NUM_AIRCRAFT = np.array([10.0, 19.0, 25.0, 15.0])
# passengers/month (hundreds) per (type, route); row 5 = slack coeff
_P = np.array([
    [16.0, 15.0, 28.0, 23.0, 81.0],
    [0.0, 10.0, 14.0, 15.0, 57.0],
    [0.0, 5.0, 0.0, 7.0, 29.0],
    [9.0, 11.0, 22.0, 17.0, 55.0],
    [1.0, 1.0, 1.0, 1.0, 1.0],
])
# $k/month per (type, route); row 5 = lost revenue per deficit unit
_C = np.array([
    [18.0, 21.0, 18.0, 16.0, 10.0],
    [0.0, 15.0, 16.0, 14.0, 9.0],
    [0.0, 10.0, 0.0, 9.0, 6.0],
    [17.0, 16.0, 17.0, 15.0, 10.0],
    [13.0, 13.0, 7.0, 7.0, 1.0],
])
_FORBIDDEN = [(1, 0), (2, 0), (2, 2)]  # (type, route), 0-indexed

# Original 1956 route-demand distributions (public data).  The
# reference's extended distributions (gbd_extended_data.json) are read
# from `data_path` where a caller gives one; no file ships with the
# repository, so by default these tables apply.
_DEMANDS_1956 = ([20, 22, 25, 27, 30], [5, 15], [14, 16, 18, 20, 22],
                 [1, 5, 8, 10, 34], [58, 60, 62])
_PROBS_1956 = ([.2, .05, .35, .2, .2], [.3, .7], [.1, .2, .4, .2, .1],
               [.2, .2, .3, .2, .1], [.1, .8, .1])


def _distributions(data_path: str | None = None):
    """(demands, probabilities) per route: the extended JSON at
    `data_path`, else the 1956 tables.  A `data_path` that does not
    exist raises FileNotFoundError."""
    if data_path is not None:
        with open(data_path) as f:
            d = json.load(f)
        dmds = tuple(np.asarray(d[f"r{i + 1}_dmds"], float)
                     for i in range(5))
        prbs = tuple(np.asarray(d[f"r{i + 1}_prbs"], float)
                     for i in range(5))
        return dmds, prbs
    return (tuple(np.asarray(v, float) for v in _DEMANDS_1956),
            tuple(np.asarray(v, float) for v in _PROBS_1956))


def sample(scennum: int, data_path: str | None = None) -> np.ndarray:
    """(5,) route demands drawn with the reference's stream (flipped
    cumulative trick included, ref:gbd.py demands_init)."""
    dmds, prbs = _distributions(data_path)
    rng = np.random.RandomState(scennum)
    r = rng.rand(5)
    out = np.empty(5)
    for g in range(5):
        cum = np.flip(np.cumsum(np.flip(prbs[g])))
        j = int(np.searchsorted(np.flip(cum), r[g]))
        out[g] = dmds[g][len(cum) - 1 - j]
    return out


def scenario_creator(scenario_name: str, num_scens: int | None = None,
                     data_path: str | None = None,
                     **_ignored) -> ScenarioSpec:
    scennum = extract_num(scenario_name)
    demand = sample(scennum, data_path)
    n = 20 + 4 + 5 + 5
    c = np.zeros(n)
    c[:20] = _C[:4].reshape(-1)          # a-major x costs
    c[24:29] = _C[4]                     # psPos: deficit lost revenue
    l = np.zeros(n)  # noqa: E741
    u = np.full(n, np.inf)
    u[:20] = np.repeat(_NUM_AIRCRAFT, 5)
    u[20:24] = _NUM_AIRCRAFT
    u[24:29] = 400.0    # deficit <= max demand (314 in the extended data)
    u[29:34] = 5000.0   # surplus bound: full fleet on one route
    for (a, r) in _FORBIDDEN:
        u[5 * a + r] = 0.0
    A = np.zeros((9, n))
    for a in range(4):
        A[a, 5 * a:5 * a + 5] = 1.0
        A[a, 20 + a] = 1.0
    for r in range(5):
        for a in range(4):
            A[4 + r, 5 * a + r] = _P[a, r]
        A[4 + r, 24 + r] = _P[4, r]      # psPos: fills a deficit (costed)
        A[4 + r, 29 + r] = -_P[4, r]     # psNeg: absorbs surplus (free)
    bl = np.concatenate([_NUM_AIRCRAFT, demand])
    bu = bl.copy()
    return ScenarioSpec(
        name=scenario_name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=np.arange(20, dtype=np.int32),
        probability=None if num_scens is None else 1.0 / num_scens,
    )


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"scen{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()


def kw_creator(cfg):
    return {"num_scens": cfg.get("num_scens")}


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
