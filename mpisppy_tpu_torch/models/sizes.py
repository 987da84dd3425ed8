###############################################################################
# sizes: the two-period SIZES product-sizing MIP (Løkketangen & Woodruff
# 1996) as BoxQP scenario specs (port of mpisppy_tpu/models/sizes.py;
# numpy only).  Matches the reference model semantics
# (ref:examples/sizes/models/ReferenceModel.py:32-176,
# ref:examples/sizes/sizes.py:13-33):
#
#   per stage s in {1,2}, sizes i=1..P (P=10):
#     z_i^s in {0,1}  produce any size i            (setup cost 453)
#     y_i^s >= 0      units produced                (unit cost ~0.75+)
#     w_ij^s >= 0     units of size i cut down to j<=i   (cut cost 0.008)
#   demand:     sum_{j>=i} w_ji^s >= D_i^s
#   setup:      y_i^s - Cap z_i^s <= 0
#   capacity:   sum_i y_i^s <= Cap            (Cap = 200,000)
#   inventory:  sum_{j<=i} w_ij^1 <= y_i^1
#               sum_{j<=i} (w_ij^1 + w_ij^2) <= y_i^1 + y_i^2
#
#   randomness: second-stage demands D^2 = mult_k * D^1 with
#   mult in {0.7, 1.0, 1.3} for 3 scenarios (the SIZES3 data,
#   ref:examples/sizes/SIZES3/Scenario*.dat), linearly spaced
#   0.7..1.3 for other scenario counts.
#
# Nonants (matching ref:sizes.py:29-30 varlist): the FIRST-STAGE
# continuous vars [NumProduced, NumUnitsCut] — the binary setup vars are
# deliberately NOT nonanticipative in the reference.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num

_P = 10
_CAP = 200000.0
_D1 = np.array([2500., 7500., 12500., 10000., 35000., 25000., 15000.,
                12500., 12500., 5000.])
_UNIT_COST = 0.748 + 0.0104 * np.arange(_P)   # 0.748 .. 0.8416
_SETUP = np.full(_P, 453.0)
_CUT_COST = 0.008

# (i, j) pairs with i >= j (cut size i down to size j), i-major
_PAIRS = [(i, j) for i in range(_P) for j in range(i + 1)]
_W = len(_PAIRS)


def demand_multiplier(scennum_1based: int, num_scens: int) -> float:
    """SIZES3: {0.7, 1.0, 1.3}; general: linspace(0.7, 1.3)."""
    if num_scens == 1:
        return 1.0
    return 0.7 + 0.6 * (scennum_1based - 1) / (num_scens - 1)


def scenario_creator(scenario_name: str, scenario_count: int = 3,
                     lp_relax: bool = False, **_ignored) -> ScenarioSpec:
    """One-based Scenario<k> names (ref:examples/sizes/sizes.py:41-46)."""
    k = extract_num(scenario_name)
    D2 = demand_multiplier(k, scenario_count) * _D1

    # columns per stage: z[0:P], y[P:2P], w[2P:2P+W]; stage2 offset nvs
    nvs = 2 * _P + _W
    n = 2 * nvs
    Z1, Y1, W1 = 0, _P, 2 * _P
    Z2, Y2, W2 = nvs, nvs + _P, nvs + 2 * _P

    c = np.zeros(n)
    for s0, (Z, Y, W) in enumerate(((Z1, Y1, W1), (Z2, Y2, W2))):
        c[Z:Z + _P] = _SETUP
        c[Y:Y + _P] = _UNIT_COST
        for w_ix, (i, j) in enumerate(_PAIRS):
            if i != j:
                c[W + w_ix] = _CUT_COST

    # rows: demand (2P), setup vub (2P), capacity (2), inventory (2P)
    m = 6 * _P + 2
    A = np.zeros((m, n))
    bl = np.full(m, -np.inf)
    bu = np.full(m, np.inf)
    r = 0
    # demand: sum_{j >= i} w_ji >= D_i   (w_ji = pair (j, i) with j >= i)
    for s0, (W, D) in enumerate(((W1, _D1), (W2, D2))):
        for i in range(_P):
            for w_ix, (jj, ii) in enumerate(_PAIRS):
                if ii == i and jj >= i:
                    A[r, W + w_ix] = 1.0
            bl[r] = D[i]
            r += 1
    # setup vub: y_i - Cap z_i <= 0
    for Z, Y in ((Z1, Y1), (Z2, Y2)):
        for i in range(_P):
            A[r, Y + i] = 1.0
            A[r, Z + i] = -_CAP
            bu[r] = 0.0
            r += 1
    # capacity: sum_i y_i <= Cap
    for Y in (Y1, Y2):
        A[r, Y:Y + _P] = 1.0
        bu[r] = _CAP
        r += 1
    # inventory stage 1: sum_{j <= i} w_ij^1 - y_i^1 <= 0
    for i in range(_P):
        for w_ix, (ii, jj) in enumerate(_PAIRS):
            if ii == i:
                A[r, W1 + w_ix] = 1.0
        A[r, Y1 + i] = -1.0
        bu[r] = 0.0
        r += 1
    # inventory cumulative: sum_{j<=i}(w^1+w^2) - y^1 - y^2 <= 0
    for i in range(_P):
        for w_ix, (ii, jj) in enumerate(_PAIRS):
            if ii == i:
                A[r, W1 + w_ix] = 1.0
                A[r, W2 + w_ix] = 1.0
        A[r, Y1 + i] = -1.0
        A[r, Y2 + i] = -1.0
        bu[r] = 0.0
        r += 1
    assert r == m

    l = np.zeros(n)  # noqa: E741
    u = np.full(n, _CAP)
    u[Z1:Z1 + _P] = 1.0
    u[Z2:Z2 + _P] = 1.0

    integer = np.zeros(n, bool)
    if not lp_relax:
        integer[Z1:Z1 + _P] = True
        integer[Z2:Z2 + _P] = True
        # NumProduced/NumUnitsCut are integers in the reference but
        # "implicitly integer ... with the PH cost objective this isn't
        # the case" (ref:ReferenceModel.py:83-85); we track only the
        # binaries, matching practical relaxations.

    # nonants = first-stage [y, w] (ref:sizes.py:29-30 varlist)
    nonant_idx = np.concatenate([np.arange(Y1, Y1 + _P),
                                 np.arange(W1, W1 + _W)]).astype(np.int32)

    return ScenarioSpec(
        name=scenario_name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=nonant_idx,
        probability=1.0 / scenario_count,
        integer=integer,
    )


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"Scenario{i + 1}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()


def kw_creator(cfg):
    return {"scenario_count": int(cfg["num_scens"]), "lp_relax": True}


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
