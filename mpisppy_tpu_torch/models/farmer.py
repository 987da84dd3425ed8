###############################################################################
# Farmer: the canonical 2-stage scalable test problem as BoxQP scenario
# specs (port of mpisppy_tpu/models/farmer.py; numpy only).  Matches the
# reference model's data, randomness, and scenario naming exactly
# (ref:examples/farmer/farmer.py:31-230):
#
#   first stage:   DevotedAcreage[crop]            (the nonants)
#   second stage:  QuantitySubQuotaSold, QuantitySuperQuotaSold,
#                  QuantityPurchased               (recourse)
#   constraints:   total acreage; cattle feed requirement; limit sold
#   randomness:    per-crop Yield — 3 base scenarios (below/avg/above),
#                  plus U[0,1) noise for scenario groups > 0 seeded with
#                  RandomState(scennum + seedoffset), one rand() per crop
#                  in WHEAT0,CORN0,SUGAR_BEETS0,WHEAT1,... order.
#
# Known answer for parity: 3-scenario EF objective = -108390
# (classic Birge & Louveaux farmer value used throughout the reference's
# examples/docs).
#
# Column layout per scenario (k = crops_multiplier, C = 3k crops):
#   [0:C)    acreage        bounds [0, 500k]          <- nonants
#   [C:2C)   sub-quota sold bounds [0, PriceQuota]
#   [2C:3C)  super-quota    bounds [0, inf)
#   [3C:4C)  purchased      bounds [0, inf)
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num

_BASE_YIELD = np.array([
    [2.0, 2.4, 16.0],   # BelowAverageScenario
    [2.5, 3.0, 20.0],   # AverageScenario
    [3.0, 3.6, 24.0],   # AboveAverageScenario
])
_PLANTING_COST = np.array([150.0, 230.0, 260.0])
_SUB_PRICE = np.array([170.0, 150.0, 36.0])
_SUPER_PRICE = np.array([0.0, 0.0, 10.0])
_PURCHASE_PRICE = np.array([238.0, 210.0, 100000.0])
_CATTLE_FEED = np.array([200.0, 240.0, 0.0])
_PRICE_QUOTA = np.array([100000.0, 100000.0, 6000.0])


def _yields(scennum: int, crops_multiplier: int, seedoffset: int) -> np.ndarray:
    base = _BASE_YIELD[scennum % 3]
    groupnum = scennum // 3
    y = np.tile(base, crops_multiplier).reshape(crops_multiplier, 3)
    if groupnum != 0:
        # one rand() per crop in CROPS order (WHEAT_i, CORN_i, SB_i for
        # each i) — ref:examples/farmer/farmer.py:157-163
        stream = np.random.RandomState(scennum + seedoffset)
        y = y + stream.rand(crops_multiplier, 3)
    return y.reshape(-1)  # (3k,)


def scenario_creator(scenario_name: str, use_integer: bool = False,
                     crops_multiplier: int = 1, num_scens: int | None = None,
                     seedoffset: int = 0) -> ScenarioSpec:
    scennum = extract_num(scenario_name)
    k = crops_multiplier
    C = 3 * k
    n = 4 * C
    total_acreage = 500.0 * k
    yields = _yields(scennum, k, seedoffset)

    tile = lambda v: np.tile(v, k)  # noqa: E731
    c = np.concatenate([
        tile(_PLANTING_COST),       # acreage
        -tile(_SUB_PRICE),          # sub-quota sales (revenue)
        -tile(_SUPER_PRICE),        # super-quota sales
        tile(_PURCHASE_PRICE),      # purchases
    ])

    # rows: [0] total acreage <= 500k
    #       [1:1+C] cattle feed: yield*acre + purch - sub - super >= CFR
    #       [1+C:1+2C] limit sold: sub + super - yield*acre <= 0
    m = 1 + 2 * C
    A = np.zeros((m, n))
    bl = np.full(m, -np.inf)
    bu = np.full(m, np.inf)

    A[0, :C] = 1.0
    bu[0] = total_acreage

    rows = 1 + np.arange(C)
    A[rows, np.arange(C)] = yields               # acre
    A[rows, 3 * C + np.arange(C)] = 1.0          # purchased
    A[rows, C + np.arange(C)] = -1.0             # sub sold
    A[rows, 2 * C + np.arange(C)] = -1.0         # super sold
    bl[rows] = tile(_CATTLE_FEED)

    rows = 1 + C + np.arange(C)
    A[rows, C + np.arange(C)] = 1.0
    A[rows, 2 * C + np.arange(C)] = 1.0
    A[rows, np.arange(C)] = -yields
    bu[rows] = 0.0

    l = np.zeros(n)
    u = np.concatenate([
        np.full(C, total_acreage),
        tile(_PRICE_QUOTA),
        np.full(C, np.inf),
        np.full(C, np.inf),
    ])

    integer = np.zeros(n, bool)
    if use_integer:
        integer[:C] = True

    return ScenarioSpec(
        name=scenario_name,
        c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=np.arange(C, dtype=np.int32),
        probability=None if num_scens is None else 1.0 / num_scens,
        integer=integer,
    )


def scenario_names_creator(num_scens: int, start: int | None = None):
    """ref:examples/farmer/farmer.py:235-240."""
    start = 0 if start is None else start
    return [f"scen{i}" for i in range(start, start + num_scens)]


# --------------------------------------------------------------------------
# Seeded scenario synthesis (scengen branch; port of the JAX package's
# models/farmer.py::scenario_program).
#
# Scenario s's yields are base[s % 3] plus U[0,1) noise per crop for
# scenario groups > 0, drawn from threefry via
# uniform(scen_key(base_key, s)) instead of RandomState(scennum +
# seedoffset): the draws differ from scenario_creator's by construction,
# and are identical to the JAX package's program.  Farmer's randomness
# enters the CONSTRAINT MATRIX, so this is the per-scenario-A program.
# --------------------------------------------------------------------------
def scenario_program(num_scens: int, seed: int = 0, start: int = 0,
                     crops_multiplier: int = 1,
                     use_integer: bool = False):
    """ScenarioProgram drawing farmer yields through scengen keys."""
    import torch

    from mpisppy_tpu_torch.scengen import random as rnd
    from mpisppy_tpu_torch.scengen.program import ScenarioProgram, scen_key

    k = int(crops_multiplier)
    C = 3 * k
    n = 4 * C
    total_acreage = 500.0 * k
    tile = lambda v: np.tile(v, k)  # noqa: E731

    c = np.concatenate([
        tile(_PLANTING_COST), -tile(_SUB_PRICE),
        -tile(_SUPER_PRICE), tile(_PURCHASE_PRICE)])
    m = 1 + 2 * C
    # yield-free skeleton of the constraint matrix (scenario_creator's
    # layout with the yield coefficients zeroed; the sampler scatters
    # the drawn yields into rows [1, 1+C) and their negation into the
    # limit rows)
    A0 = np.zeros((m, n))
    A0[0, :C] = 1.0
    rows = 1 + np.arange(C)
    A0[rows, 3 * C + np.arange(C)] = 1.0
    A0[rows, C + np.arange(C)] = -1.0
    A0[rows, 2 * C + np.arange(C)] = -1.0
    rows2 = 1 + C + np.arange(C)
    A0[rows2, C + np.arange(C)] = 1.0
    A0[rows2, 2 * C + np.arange(C)] = 1.0
    bl = np.full(m, -np.inf)
    bu = np.full(m, np.inf)
    bu[0] = total_acreage
    bl[1:1 + C] = tile(_CATTLE_FEED)
    bu[1 + C:1 + 2 * C] = 0.0
    l = np.zeros(n)  # noqa: E741
    u = np.concatenate([np.full(C, total_acreage), tile(_PRICE_QUOTA),
                        np.full(C, np.inf), np.full(C, np.inf)])
    integer = np.zeros(n, bool)
    if use_integer:
        integer[:C] = True

    A0_f = torch.as_tensor(A0.astype(np.float32))
    base_f = torch.as_tensor(_BASE_YIELD.astype(np.float32))
    feed_rows = torch.as_tensor(rows)
    limit_rows = torch.as_tensor(rows2)
    acre_cols = torch.arange(C)

    def sampler(base_key, idx):
        dev = idx.device
        K = idx.shape[0]
        base = base_f.to(dev)[idx % 3].repeat(1, k)            # (K, C)
        noise = rnd.uniform(scen_key(base_key, idx), (k, 3)).reshape(K, C)
        y = base + torch.where((idx // 3 > 0)[:, None], noise,
                               torch.zeros_like(noise))
        A = A0_f.to(dev).expand(K, m, n).clone()
        A[:, feed_rows.to(dev), acre_cols.to(dev)] = y
        A[:, limit_rows.to(dev), acre_cols.to(dev)] = -y
        return {"A": A}

    return ScenarioProgram(
        name="farmer", num_scenarios=int(num_scens),
        base_seed=int(seed), start=int(start),
        template={"c": c, "A": A0, "bl": bl, "bu": bu, "l": l, "u": u},
        varying=("A",), sampler=sampler,
        nonant_idx=np.arange(C, dtype=np.int32),
        integer=integer if use_integer else None,
    )


# --------------------------------------------------------------------------
# CLI hooks (the generic driver's model API, generic_cylinders.py)
# --------------------------------------------------------------------------
def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("crops_multiplier",
                      description="number of crops will be three times this",
                      domain=int, default=1)
    cfg.add_to_config("farmer_with_integers",
                      description="integer acreage variant",
                      domain=bool, default=False)


def kw_creator(cfg):
    return {
        "use_integer": cfg.get("farmer_with_integers", False),
        "crops_multiplier": cfg.get("crops_multiplier", 1),
        "num_scens": cfg.get("num_scens", None),
    }


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
