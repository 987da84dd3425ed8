###############################################################################
# distr: inter-region minimum-cost distribution via consensus ADMM (port
# of mpisppy_tpu/models/distr.py; numpy, scipy for the oracle; ref:examples/distr/distr.py + distr_data.py).  Regions are the admm
# "scenarios"; inter-region arc flows are the consensus variables, each
# arc's cost split half/half between its two regions
# (ref:distr.py:23-50 inter_arcs_adder).
#
# Synthetic seeded data in the reference's shape: each region has a
# factory node F (bounded production), a distribution center DC, and a
# buyer node B (fixed demand, slack with penalty so every region is
# feasible standalone); inter-region arcs form a ring DC_r -> DC_{r+1}.
#
# Region LP (min):  prod_cost*g + sum arc_cost*f + penalty*unmet
#   s.t.  F:  g - f_{F->DC} = 0
#         DC: f_{F->DC} + sum_in f_inter - f_{DC->B}
#             - sum_out f_inter = 0
#         B:  f_{DC->B} + unmet = demand
# with box capacities on every flow.  The consensus labels are the
# inter-arc flow names, shared by source and target region — exactly
# the reference's nonant choice.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec

_PENALTY = 1000.0


def region_data(num_regions: int, seed: int = 0) -> dict:
    """Seeded synthetic inter-region network (ref:distr_data.py shape)."""
    rng = np.random.RandomState(seed + 31 * num_regions)
    regions = {}
    for r in range(num_regions):
        regions[f"Region{r}"] = {
            "prod_cap": float(rng.uniform(80.0, 160.0)),
            "prod_cost": float(rng.uniform(2.0, 8.0)),
            "demand": float(rng.uniform(60.0, 120.0)),
            "intra_cost": float(rng.uniform(0.5, 2.0)),
            "intra_cap": 500.0,
        }
    inter = {}
    for r in range(num_regions):
        t = (r + 1) % num_regions
        if num_regions > 1:
            inter[(f"Region{r}", f"Region{t}")] = {
                "cap": float(rng.uniform(30.0, 80.0)),
                "cost": float(rng.uniform(1.0, 4.0)),
            }
    return {"regions": regions, "inter": inter}


def _region_arcs(region: str, data: dict):
    """(incoming, outgoing) inter-arc keys touching `region`."""
    inc = [k for k in data["inter"] if k[1] == region]
    out = [k for k in data["inter"] if k[0] == region]
    return inc, out


def arc_label(key) -> str:
    return f"flow_{key[0]}_{key[1]}"


def scenario_creator(scenario_name: str, data: dict | None = None,
                     num_regions: int | None = None, seed: int = 0,
                     **_ignored):
    """Returns (ScenarioSpec, var_names) — the admmWrapper contract
    (consensus labels resolved by name, ref:distr.py nonant choice)."""
    if data is None:
        data = region_data(num_regions or 3, seed)
    rd = data["regions"][scenario_name]
    inc, out = _region_arcs(scenario_name, data)

    # columns: g, f_FDC, f_DCB, unmet, then one per touching inter arc
    var_names = ["g", "f_FDC", "f_DCB", "unmet"] \
        + [arc_label(k) for k in inc + out]
    n = len(var_names)
    c = np.zeros(n)
    c[0] = rd["prod_cost"]
    c[1] = rd["intra_cost"]
    c[2] = rd["intra_cost"]
    c[3] = _PENALTY
    l = np.zeros(n)  # noqa: E741
    u = np.empty(n)
    u[0] = rd["prod_cap"]
    u[1] = rd["intra_cap"]
    u[2] = rd["intra_cap"]
    u[3] = rd["demand"]
    for j, k in enumerate(inc + out):
        # half the arc cost to each side (ref:distr.py:36 note)
        c[4 + j] = data["inter"][k]["cost"] / 2.0
        u[4 + j] = data["inter"][k]["cap"]

    # rows: F balance, DC balance, B balance
    A = np.zeros((3, n))
    A[0, 0] = 1.0
    A[0, 1] = -1.0
    A[1, 1] = 1.0
    A[1, 2] = -1.0
    for j, k in enumerate(inc):
        A[1, 4 + j] = 1.0
    for j, k in enumerate(out):
        A[1, 4 + len(inc) + j] = -1.0
    A[2, 2] = 1.0
    A[2, 3] = 1.0
    bl = np.array([0.0, 0.0, rd["demand"]])
    bu = bl.copy()

    spec = ScenarioSpec(
        name=scenario_name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=np.arange(0, dtype=np.int32),  # set by the wrapper
    )
    return spec, var_names


def consensus_vars_creator(num_regions: int, data: dict | None = None,
                           seed: int = 0) -> dict:
    """region -> list of consensus labels (both endpoint regions carry
    each inter arc, ref:distr_admm_cylinders.py consensus setup)."""
    if data is None:
        data = region_data(num_regions, seed)
    out: dict = {}
    for r in data["regions"]:
        inc, outg = _region_arcs(r, data)
        out[r] = [arc_label(k) for k in inc + outg]
    return out


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"Region{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()


def kw_creator(cfg):
    ns = int(cfg["num_scens"])
    return {"data": region_data(ns), "num_regions": ns}


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass


def global_lp_oracle(data: dict):
    """The merged single-LP optimum via scipy (test oracle, the analog
    of ref:examples/distr/globalmodel.py)."""
    from scipy.optimize import linprog

    regions = list(data["regions"])
    inter = list(data["inter"])
    # columns: per region (g, f_FDC, f_DCB, unmet) then one per inter arc
    nr = len(regions)
    n = 4 * nr + len(inter)
    c = np.zeros(n)
    lb = np.zeros(n)
    ub = np.empty(n)
    for i, r in enumerate(regions):
        rd = data["regions"][r]
        c[4 * i:4 * i + 4] = [rd["prod_cost"], rd["intra_cost"],
                              rd["intra_cost"], _PENALTY]
        ub[4 * i:4 * i + 4] = [rd["prod_cap"], rd["intra_cap"],
                               rd["intra_cap"], rd["demand"]]
    for j, k in enumerate(inter):
        c[4 * nr + j] = data["inter"][k]["cost"]
        ub[4 * nr + j] = data["inter"][k]["cap"]
    A_eq, b_eq = [], []
    for i, r in enumerate(regions):
        rd = data["regions"][r]
        row = np.zeros(n)
        row[4 * i] = 1.0
        row[4 * i + 1] = -1.0
        A_eq.append(row); b_eq.append(0.0)
        row = np.zeros(n)
        row[4 * i + 1] = 1.0
        row[4 * i + 2] = -1.0
        for j, k in enumerate(inter):
            if k[1] == r:
                row[4 * nr + j] = 1.0
            if k[0] == r:
                row[4 * nr + j] = -1.0
        A_eq.append(row); b_eq.append(0.0)
        row = np.zeros(n)
        row[4 * i + 2] = 1.0
        row[4 * i + 3] = 1.0
        A_eq.append(row); b_eq.append(rd["demand"])
    res = linprog(c, A_eq=np.array(A_eq), b_eq=np.array(b_eq),
                  bounds=list(zip(lb, ub)), method="highs")
    assert res.success
    return float(res.fun)
