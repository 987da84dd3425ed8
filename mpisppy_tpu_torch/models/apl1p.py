###############################################################################
# APL1P: two-generator capacity expansion under demand + availability
# uncertainty (port of mpisppy_tpu/models/apl1p.py; numpy only;
# ref:mpisppy/tests/examples/apl1p.py; costs follow Bailey,
# Jensen & Morton's response-surface study of the Infanger 1992 model).
#
# First stage: generator capacities Cap_g >= Cmin (continuous nonants).
# Second stage: operation levels Op_{g,dl} per demand level and unserved
# demand U_dl with penalty cost.  Per-scenario randomness (seeded
# exactly like the reference: RandomState(scennum).rand(6), indices 1-2
# for availability, 3-5 for demand):
#     Avail_g  ~ discrete({1,.9,.5,.1} / {1,.9,.7,.1,0})
#     Demand_dl ~ discrete({900,1000,1100,1200})
#
# Columns (n = 11): [Cap_1, Cap_2, Op_{1,1..3}, Op_{2,1..3}, U_{1..3}]
# Rows (m = 5): max-operating per g (sum_dl Op_gdl - Avail_g Cap_g <= 0)
#               demand per dl (sum_g Op_gdl + U_dl >= Demand_dl)
# (Cmin enters as the Cap box lower bound.)
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num

_AVAIL_OUTCOME = ([1.0, 0.9, 0.5, 0.1], [1.0, 0.9, 0.7, 0.1, 0.0])
_AVAIL_CUMPROB = (np.cumsum([0.2, 0.3, 0.4, 0.1]),
                  np.cumsum([0.1, 0.2, 0.5, 0.1, 0.1]))
_DEMAND_OUTCOME = [900.0, 1000.0, 1100.0, 1200.0]
_DEMAND_CUMPROB = np.cumsum([0.15, 0.45, 0.25, 0.15])
_INVEST = np.array([4.0, 2.5])
_OP_COST = np.array([[4.3, 2.0, 0.5], [8.7, 4.0, 1.0]])
_UNSERVED = 10.0
_CMIN = 1000.0


def sample(scennum: int):
    """(avail (2,), demand (3,)) drawn with the reference's stream."""
    rng = np.random.RandomState(scennum)
    r = rng.rand(6)
    avail = np.array([
        _AVAIL_OUTCOME[g][int(np.searchsorted(_AVAIL_CUMPROB[g], r[g + 1]))]
        for g in range(2)])
    demand = np.array([
        _DEMAND_OUTCOME[int(np.searchsorted(_DEMAND_CUMPROB, r[3 + dl]))]
        for dl in range(3)])
    return avail, demand


def scenario_creator(scenario_name: str, num_scens: int | None = None,
                     **_ignored) -> ScenarioSpec:
    scennum = extract_num(scenario_name)
    avail, demand = sample(scennum)
    n = 11
    c = np.concatenate([_INVEST, _OP_COST.reshape(-1),
                        np.full(3, _UNSERVED)])
    l = np.zeros(n)  # noqa: E741
    l[:2] = _CMIN
    u = np.full(n, np.inf)
    # generous finite caps keep every dual bound finite for the B&B path
    u[:2] = 10_000.0
    u[2:] = 5_000.0
    A = np.zeros((5, n))
    for g in range(2):
        A[g, 2 + 3 * g:5 + 3 * g] = 1.0
        A[g, g] = -avail[g]
    for dl in range(3):
        A[2 + dl, 2 + dl] = 1.0      # Op_{1,dl}
        A[2 + dl, 5 + dl] = 1.0      # Op_{2,dl}
        A[2 + dl, 8 + dl] = 1.0      # U_dl
    bl = np.concatenate([np.full(2, -np.inf), demand])
    bu = np.concatenate([np.zeros(2), np.full(3, np.inf)])
    return ScenarioSpec(
        name=scenario_name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=np.arange(2, dtype=np.int32),
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
