###############################################################################
# Hydro (elec3): the canonical 3-stage hydro-thermal scheduling problem
# as BoxQP scenario specs (port of mpisppy_tpu/models/hydro.py; numpy
# only).  Matches the reference model's data and tree semantics
# (ref:examples/hydro/hydro.py:42-151,216-244 and the PySP node data
# ref:examples/hydro/PySP/nodedata/*.dat):
#
#   per stage t=1..3:  Pgt[t] thermal gen   in [0, 100]
#                      Pgh[t] hydro gen     in [0, 100]
#                      PDns[t] unserved     in [0, D_t]
#                      Vol[t] reservoir     in [0, 100]
#   plus sl >= 0 (future-cost slack at the last stage).
#   demand:   Pgt_t + Pgh_t + PDns_t = D_t
#   conserv:  Vol_t - Vol_{t-1} + u_t Pgh_t <= u_t A_t   (Vol_0 = V0)
#   fcfe:     sl + 4166.67 Vol_3 >= 4166.67 V0
#   obj:      sum_t r_t (betaGt Pgt_t + betaDns PDns_t) + sl,
#             r_t = (1/1.1)^(duracion_t / T)
#
#   randomness: inflow A_2 in {10,50,90} per stage-2 branch and
#               A_3 in {40,50,60} per leaf branch (9 scenarios, bf=(3,3));
#               A_1 = 50 deterministic.
#
# Nonant slots (stage-major, matching MakeNodesforScen
# ref:examples/hydro/hydro.py:185-216): stage-1 [Pgt1,Pgh1,PDns1,Vol1],
# stage-2 [Pgt2,Pgh2,PDns2,Vol2]; N = 8, tree bf = branching_factors.
#
# Larger trees (scaling studies): branching factors beyond (3,3) draw
# inflows from a seeded uniform range per node, keeping the reference
# values for the first three branches.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.core.tree import ScenarioTree
from mpisppy_tpu_torch.utils.sputils import extract_num

_D = np.array([90.0, 160.0, 110.0])
_U = np.array([0.6048, 0.6048, 1.2096])
_DURACION = np.array([168.0, 168.0, 336.0])
_T = 8760.0
_V0 = 60.48
_VMAX = 100.0
_PMAX = 100.0
_BETA_GT = 1.0
_BETA_GH = 0.0
_BETA_DNS = 10.0
_FCFE = 4166.67
_A1 = 50.0
_A2_BASE = np.array([10.0, 50.0, 90.0])   # ref:PySP/nodedata/Node2_*.dat
_A3_BASE = np.array([40.0, 50.0, 60.0])   # ref:PySP/nodedata/Node3_*_*.dat


def _inflow(base: np.ndarray, branch: int, seed_tag: int) -> float:
    if branch < len(base):
        return float(base[branch])
    rng = np.random.RandomState(1_000_003 * seed_tag + branch)
    return float(rng.uniform(base.min(), base.max()))


def scenario_creator(scenario_name: str,
                     branching_factors=(3, 3)) -> ScenarioSpec:
    """One-based Scen<k> names (ref:examples/hydro/hydro.py:216-244)."""
    bfs = tuple(int(b) for b in branching_factors)
    if len(bfs) != 2:
        raise ValueError("hydro is a 3-stage problem: two branching factors")
    snum = extract_num(scenario_name)          # one-based
    b1 = (snum - 1) // bfs[1]
    b2 = (snum - 1) % bfs[1]
    A = np.array([_A1, _inflow(_A2_BASE, b1, 2),
                  _inflow(_A3_BASE, b2, 3)])

    r = (1.0 / 1.1) ** (_DURACION / _T)

    # columns: Pgt[0:3], Pgh[3:6], PDns[6:9], Vol[9:12], sl[12]
    n = 13
    PGT, PGH, PDNS, VOL, SL = 0, 3, 6, 9, 12
    c = np.zeros(n)
    c[PGT:PGT + 3] = r * _BETA_GT
    c[PGH:PGH + 3] = r * _BETA_GH
    c[PDNS:PDNS + 3] = r * _BETA_DNS
    c[SL] = 1.0

    # rows: demand (3 eq), conservation (3 ineq), fcfe (1 ineq)
    m = 7
    Am = np.zeros((m, n))
    bl = np.full(m, -np.inf)
    bu = np.full(m, np.inf)
    for t in range(3):
        Am[t, PGT + t] = 1.0
        Am[t, PGH + t] = 1.0
        Am[t, PDNS + t] = 1.0
        bl[t] = bu[t] = _D[t]
    for t in range(3):
        row = 3 + t
        Am[row, VOL + t] = 1.0
        if t > 0:
            Am[row, VOL + t - 1] = -1.0
        Am[row, PGH + t] = _U[t]
        bu[row] = _U[t] * A[t] + (_V0 if t == 0 else 0.0)
    Am[6, SL] = 1.0
    Am[6, VOL + 2] = _FCFE
    bl[6] = _FCFE * _V0

    l = np.zeros(n)  # noqa: E741
    u = np.concatenate([
        np.full(3, _PMAX),        # Pgt
        np.full(3, _PMAX),        # Pgh
        _D,                       # PDns
        np.full(3, _VMAX),        # Vol
        [np.inf],                 # sl
    ])

    # stage-major nonant slots: stage-1 then stage-2 variables
    nonant_idx = np.array([PGT, PGH, PDNS, VOL,
                           PGT + 1, PGH + 1, PDNS + 1, VOL + 1], np.int32)

    return ScenarioSpec(
        name=scenario_name, c=c, A=Am, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=nonant_idx,
        probability=1.0 / (bfs[0] * bfs[1]),
    )


def make_tree(branching_factors=(3, 3)) -> ScenarioTree:
    return ScenarioTree(branching_factors=tuple(branching_factors),
                        nonants_per_stage=(4, 4))


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 1 if start is None else start
    return [f"Scen{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.add_to_config("branching_factors",
                      description="two branching factors, e.g. 3 3",
                      domain=list, default=[3, 3])


def kw_creator(cfg):
    return {"branching_factors":
            tuple(cfg.get("branching_factors", (3, 3)))}


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
