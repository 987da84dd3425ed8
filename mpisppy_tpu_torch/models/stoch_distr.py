###############################################################################
# stoch_distr: STOCHASTIC inter-region distribution — scenario x region
# consensus ADMM through utils.stoch_admmWrapper (port of
# mpisppy_tpu/models/stoch_distr.py; ref:examples/stoch_distr/stoch_distr.py + stoch_distr_admm_cylinders.py).
#
# The deterministic distr network (models/distr.py) gains:
#   * stochastic demand: each stochastic scenario scales every region's
#     demand by a seeded multiplier (the reference's stochastic
#     scenario axis, ref:stoch_distr.py scenario_creator);
#   * a GLOBAL first-stage decision z >= 0 — emergency production
#     capacity available to every region's factory — nonanticipative
#     across stochastic scenarios and shared by all regions (the
#     stage-1 slot block of utils.stoch_admmWrapper).
#
# Each (stoch scenario, region) pair model (min):
#     (cz/R) z + prod_cost g + intra costs + arc costs/2 + penalty unmet
#   s.t.  F:   g - f_FDC = 0
#         DC:  f_FDC + sum_in f - f_DCB - sum_out f = 0
#         B:   f_DCB + unmet = demand_r * mult_s
#         cap: g - z <= prod_cap_r
# (z's cost is split across the R regions because the stoch_admmWrapper
# expectation counts each pair's objective once per region.)
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.models import distr

_PENALTY = 1000.0
_Z_COST = 4.0
_Z_MAX = 200.0


def demand_multiplier(stoch_name: str, seed: int = 0) -> float:
    """Seeded per-scenario demand scaling (ref:stoch_distr.py's
    stochastic demand draw)."""
    from mpisppy_tpu_torch.utils.sputils import extract_num
    rng = np.random.RandomState(20_000 + extract_num(stoch_name) + seed)
    return float(rng.uniform(0.7, 1.3))


def scenario_creator(stoch_name: str, region_name: str,
                     data: dict | None = None,
                     num_regions: int | None = None, seed: int = 0,
                     **_ignored):
    """(ScenarioSpec, var_names) for one (stoch scenario, region) pair —
    the utils.stoch_admmWrapper contract.  nonant_idx marks the ORIGINAL
    first-stage column (z)."""
    if data is None:
        data = distr.region_data(num_regions or 3, seed)
    R = len(data["regions"])
    rd = data["regions"][region_name]
    inc, out = distr._region_arcs(region_name, data)
    mult = demand_multiplier(stoch_name, seed)
    demand = rd["demand"] * mult

    # columns: z, g, f_FDC, f_DCB, unmet, then one per touching arc
    var_names = ["z", "g", "f_FDC", "f_DCB", "unmet"] \
        + [distr.arc_label(k) for k in inc + out]
    n = len(var_names)
    c = np.zeros(n)
    c[0] = _Z_COST / R
    c[1] = rd["prod_cost"]
    c[2] = rd["intra_cost"]
    c[3] = rd["intra_cost"]
    c[4] = _PENALTY
    l = np.zeros(n)  # noqa: E741
    u = np.empty(n)
    u[0] = _Z_MAX
    u[1] = rd["prod_cap"] + _Z_MAX
    u[2] = rd["intra_cap"]
    u[3] = rd["intra_cap"]
    u[4] = demand
    for j, k in enumerate(inc + out):
        c[5 + j] = data["inter"][k]["cost"] / 2.0
        u[5 + j] = data["inter"][k]["cap"]

    # rows: F balance, DC balance, B balance, capacity link
    A = np.zeros((4, n))
    A[0, 1] = 1.0
    A[0, 2] = -1.0
    A[1, 2] = 1.0
    A[1, 3] = -1.0
    for j, k in enumerate(inc):
        A[1, 5 + j] = 1.0
    for j, k in enumerate(out):
        A[1, 5 + len(inc) + j] = -1.0
    A[2, 3] = 1.0
    A[2, 4] = 1.0
    A[3, 1] = 1.0
    A[3, 0] = -1.0
    bl = np.array([0.0, 0.0, demand, -np.inf])
    bu = np.array([0.0, 0.0, demand, rd["prod_cap"]])

    spec = ScenarioSpec(
        name=f"{stoch_name}_{region_name}", c=c, A=A, bl=bl, bu=bu,
        l=l, u=u,
        nonant_idx=np.arange(1, dtype=np.int32),  # z is column 0
    )
    return spec, var_names


def consensus_vars_creator(num_regions: int, data: dict | None = None,
                           seed: int = 0) -> dict:
    """Same inter-arc consensus labels as deterministic distr
    (ref:stoch_distr.py:212-261 builds them from the inter-region
    dict)."""
    return distr.consensus_vars_creator(num_regions, data, seed)


def stoch_scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"StochScen{i}" for i in range(start, start + num_scens)]


def admm_subproblem_names_creator(num_regions: int):
    return distr.scenario_names_creator(num_regions)


def global_lp_oracle(data: dict, stoch_names: list[str],
                     seed: int = 0) -> float:
    """Merged two-stage LP optimum via scipy: shared z, per-(s, arc)
    flows, per-(s, region) recourse — the analog of
    ref:examples/stoch_distr/globalmodel.py."""
    from scipy.optimize import linprog

    regions = list(data["regions"])
    inter = list(data["inter"])
    R, S = len(regions), len(stoch_names)
    p_s = 1.0 / S
    # columns: z | for each s: per region (g, f1, f2, unmet) | arcs
    per_s = 4 * R + len(inter)
    n = 1 + S * per_s
    c = np.zeros(n)
    lb = np.zeros(n)
    ub = np.empty(n)
    c[0] = _Z_COST
    ub[0] = _Z_MAX
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for si, snm in enumerate(stoch_names):
        mult = demand_multiplier(snm, seed)
        base = 1 + si * per_s
        for i, r in enumerate(regions):
            rd = data["regions"][r]
            j0 = base + 4 * i
            c[j0:j0 + 4] = p_s * np.array(
                [rd["prod_cost"], rd["intra_cost"], rd["intra_cost"],
                 _PENALTY])
            ub[j0:j0 + 4] = [rd["prod_cap"] + _Z_MAX, rd["intra_cap"],
                             rd["intra_cap"], rd["demand"] * mult]
            # capacity link g - z <= prod_cap
            row = np.zeros(n)
            row[j0] = 1.0
            row[0] = -1.0
            A_ub.append(row)
            b_ub.append(rd["prod_cap"])
            # F balance
            row = np.zeros(n)
            row[j0] = 1.0
            row[j0 + 1] = -1.0
            A_eq.append(row)
            b_eq.append(0.0)
            # DC balance
            row = np.zeros(n)
            row[j0 + 1] = 1.0
            row[j0 + 2] = -1.0
            for aj, k in enumerate(inter):
                if k[1] == r:
                    row[base + 4 * R + aj] = 1.0
                if k[0] == r:
                    row[base + 4 * R + aj] = -1.0
            A_eq.append(row)
            b_eq.append(0.0)
            # B balance
            row = np.zeros(n)
            row[j0 + 2] = 1.0
            row[j0 + 3] = 1.0
            A_eq.append(row)
            b_eq.append(rd["demand"] * mult)
        for aj, k in enumerate(inter):
            j = base + 4 * R + aj
            c[j] = p_s * data["inter"][k]["cost"]
            ub[j] = data["inter"][k]["cap"]
    res = linprog(c, A_ub=np.array(A_ub), b_ub=np.array(b_ub),
                  A_eq=np.array(A_eq), b_eq=np.array(b_eq),
                  bounds=list(zip(lb, ub)), method="highs")
    assert res.status == 0, res.message
    return float(res.fun)
