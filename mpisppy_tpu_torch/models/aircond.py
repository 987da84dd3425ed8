###############################################################################
# aircond: the multistage air-conditioner production planning problem
# as BoxQP scenario specs (port of mpisppy_tpu/models/aircond.py; numpy
# only, scenario_program on torch).  Matches the reference model's
# semantics
# (ref:mpisppy/tests/examples/aircond.py:26-254):
#
#   per stage t=1..T:
#     Reg_t in [0, Capacity]   regular production  (cost 1.0)
#     OT_t  in [0, bigM]       overtime production (cost 3.0)
#     posI_t, negI_t >= 0      inventory split (Inventory = posI - negI)
#   balance:  (posI_{t-1} - negI_{t-1}) + Reg_t + OT_t
#                 - posI_t + negI_t = d_t        (I_0 = BeginInventory)
#   objective: sum_t RegCost*Reg + OTCost*OT + InvCost_t*posI
#                 + NegInvCost*negI,
#     with InvCost_t = 0.5 for t<T and LastInventoryCost = -0.8
#     (salvage) at t=T (ref:aircond.py:95-160 InvenCostExpr).
#
#   randomness (ref:aircond.py:44-75 _demands_creator): demand follows a
#   clipped random walk over the scenario tree — d_1 = starting_d, and
#   each stage-t tree node draws d_t = clip(d_{t-1} + N(mu_dev,
#   sigma_dev), min_d, max_d) from a stream seeded with start_seed +
#   node_idx(path), so all scenarios through a node share its demand
#   (the reference's node-keyed seeding, ref:sputils.py:508-536).
#
# Nonants per non-leaf stage (ref:aircond.py:256-268 MakeNodesforScen):
# [Reg_t, OT_t] — 2 slots per stage, stage-major.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.core.tree import ScenarioTree
from mpisppy_tpu_torch.utils.sputils import extract_num

# defaults (ref:mpisppy/tests/examples/aircond.py:26-42 parms)
DEFAULTS = dict(
    mu_dev=0.0, sigma_dev=40.0, start_seed=1134,
    min_d=0.0, max_d=400.0, starting_d=200.0,
    BeginInventory=200.0, InventoryCost=0.5, LastInventoryCost=-0.8,
    Capacity=200.0, RegularProdCost=1.0, OvertimeProdCost=3.0,
    NegInventoryCost=5.0,
)
_MAX_T = 25
_BIGM_FACTOR = _MAX_T


def _node_idx(path: list[int], bfs: tuple[int, ...]) -> int:
    """Unique node id along a path (ref:sputils.py:508-536 node_idx)."""
    if not path:
        return 0
    stage_id = 0
    before = 1
    acc = 1
    for t in range(len(path) - 1):
        acc *= bfs[t]
        before += acc
    for t, b in enumerate(path):
        stage_id = path[t] + bfs[t] * stage_id
    return before + stage_id


def demands_for_scenario(scennum: int, bfs: tuple[int, ...],
                         **kw) -> np.ndarray:
    """Stage demands along scenario scennum's tree path
    (ref:aircond.py:44-75)."""
    p = {**DEFAULTS, **kw}
    prod = int(np.prod(bfs))
    s = scennum % prod
    path = []
    rem = prod
    for b in bfs:
        rem //= b
        path.append(s // rem)
        s %= rem
    d = p["starting_d"]
    demands = [d]
    for t in range(1, len(bfs) + 1):
        seed = p["start_seed"] + _node_idx(path[:t], bfs)
        rng = np.random.RandomState(seed)
        d = min(p["max_d"], max(p["min_d"],
                                d + rng.normal(p["mu_dev"],
                                               p["sigma_dev"])))
        demands.append(d)
    return np.array(demands)


def scenario_creator(scenario_name: str,
                     branching_factors=(3, 3, 2), **kw) -> ScenarioSpec:
    """Zero-based Scenario<k> names.  T = len(bfs) + 1 stages."""
    p = {**DEFAULTS, **kw}
    bfs = tuple(int(b) for b in branching_factors)
    T = len(bfs) + 1
    if T > _MAX_T:
        raise ValueError(f"at most {_MAX_T} stages (ref:aircond.py:103)")
    scennum = extract_num(scenario_name)
    d = demands_for_scenario(scennum, bfs, **kw)
    bigM = p["Capacity"] * _BIGM_FACTOR

    # columns: Reg[0:T], OT[T:2T], posI[2T:3T], negI[3T:4T]
    n = 4 * T
    REG, OT, PI, NI = 0, T, 2 * T, 3 * T
    c = np.zeros(n)
    c[REG:REG + T] = p["RegularProdCost"]
    c[OT:OT + T] = p["OvertimeProdCost"]
    c[PI:PI + T] = p["InventoryCost"]
    c[PI + T - 1] = p["LastInventoryCost"]
    c[NI:NI + T] = p["NegInventoryCost"]

    # balance rows
    A = np.zeros((T, n))
    bl = np.empty(T)
    for t in range(T):
        A[t, REG + t] = 1.0
        A[t, OT + t] = 1.0
        A[t, PI + t] = -1.0
        A[t, NI + t] = 1.0
        if t > 0:
            A[t, PI + t - 1] = 1.0
            A[t, NI + t - 1] = -1.0
        bl[t] = d[t] - (p["BeginInventory"] if t == 0 else 0.0)
    bu = bl.copy()

    l = np.zeros(n)  # noqa: E741
    u = np.full(n, bigM)
    u[REG:REG + T] = p["Capacity"]

    # nonants: [Reg_t, OT_t] per non-leaf stage, stage-major
    nonant_idx = np.array(
        [v for t in range(T - 1) for v in (REG + t, OT + t)], np.int32)

    return ScenarioSpec(
        name=scenario_name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=nonant_idx,
        probability=1.0 / int(np.prod(bfs)),
    )


# --------------------------------------------------------------------------
# Seeded scenario synthesis (scengen branch; port of the JAX package's
# models/aircond.py::scenario_program).
#
# aircond is the multistage program of the family: demand follows a
# clipped random walk over the tree, with one draw per non-root tree
# node shared by every scenario through that node.  The program keeps
# that node-keyed structure but folds the node id into the counter-based
# key, fold_in(base_key, node_idx(path)), instead of seeding a
# RandomState per node, so the data's nonanticipativity holds under any
# tiling.  The draws are scengen.random.normal, the port's bit-exact
# jax.random.normal, so the port's program draws the JAX program's
# scenarios bit for bit.  The walk is a normal, not a Bernoulli row, so
# the program declares no row_draws: its VirtualBatch realizes the batch
# (realize()) and scengen.window_inputs raises for it.
# --------------------------------------------------------------------------
def scenario_program(num_scens: int, seed: int = 0, start: int = 0,
                     branching_factors=(3, 3, 2), **kw):
    """ScenarioProgram drawing the node demand walk through scengen
    keys.  num_scens must equal prod(branching_factors)."""
    import torch

    from mpisppy_tpu_torch.scengen import random as rnd
    from mpisppy_tpu_torch.scengen.program import ScenarioProgram

    if int(start) != 0:
        # node keys derive from the within-tree path (idx % prod), so a
        # start offset would replay the same tree: replicate multistage
        # samples by varying `seed` (one base key per tree)
        raise ValueError("aircond program: replications vary `seed`, "
                         "not `start` (node-keyed draws)")
    kw.pop("start_seed", None)  # scenario_creator's RandomState knob
    p = {**DEFAULTS, **kw}
    bfs = tuple(int(b) for b in branching_factors)
    prod = int(np.prod(bfs))
    if int(num_scens) != prod:
        raise ValueError(f"aircond program needs num_scens == "
                         f"prod(branching_factors) = {prod}")
    T = len(bfs) + 1
    bigM = p["Capacity"] * _BIGM_FACTOR

    n = 4 * T
    REG, OT, PI, NI = 0, T, 2 * T, 3 * T
    c = np.zeros(n)
    c[REG:REG + T] = p["RegularProdCost"]
    c[OT:OT + T] = p["OvertimeProdCost"]
    c[PI:PI + T] = p["InventoryCost"]
    c[PI + T - 1] = p["LastInventoryCost"]
    c[NI:NI + T] = p["NegInventoryCost"]
    A = np.zeros((T, n))
    for t in range(T):
        A[t, REG + t] = 1.0
        A[t, OT + t] = 1.0
        A[t, PI + t] = -1.0
        A[t, NI + t] = 1.0
        if t > 0:
            A[t, PI + t - 1] = 1.0
            A[t, NI + t - 1] = -1.0
    l = np.zeros(n)  # noqa: E741
    u = np.full(n, bigM)
    u[REG:REG + T] = p["Capacity"]
    bl0 = np.zeros(T)
    bl0[0] = p["starting_d"] - p["BeginInventory"]
    nonant_idx = np.array(
        [v for t in range(T - 1) for v in (REG + t, OT + t)], np.int32)

    # static node-id arithmetic of _node_idx, per path length
    before = []
    for L in range(1, T):
        b_, acc = 1, 1
        for t in range(L - 1):
            acc *= bfs[t]
            b_ += acc
        before.append(b_)
    f32 = np.float32
    mu = float(f32(p["mu_dev"]))
    # XLA folds the JAX program's sigma * (sqrt(2) * erfinv(u)) into
    # erfinv(u) * f32(sqrt(2) * sigma) and its CPU backend contracts the
    # add into an FMA: the walk below does the same arithmetic
    scale = float(f32(f32(rnd.SQRT2_F32) * f32(p["sigma_dev"])))
    min_d, max_d = float(f32(p["min_d"])), float(f32(p["max_d"]))
    start_d = float(f32(p["starting_d"]))
    row0 = float(f32(p["starting_d"] - p["BeginInventory"]))

    def sampler(base_key, idx):
        # path digits of each scenario (depth-first layout), batched
        # over the index vector idx (k,)
        s = idx % prod
        rem = prod
        digits = []
        for b in bfs:
            rem = rem // b
            digits.append(s // rem)
            s = s % rem
        d = torch.full(idx.shape, start_d, dtype=torch.float32,
                       device=idx.device)
        rows = [torch.full_like(d, row0)]
        for t in range(1, T):
            sid = torch.zeros_like(idx)
            for tt in range(t):
                sid = digits[tt] + bfs[tt] * sid
            node = before[t - 1] + sid
            e = rnd.erfinv(rnd.normal_operand(rnd.fold_in(base_key, node),
                                              ()))
            d = torch.clamp(rnd.fma_f32(e, scale, d + mu), min_d, max_d)
            rows.append(d)
        bl = torch.stack(rows, dim=1)
        return {"bl": bl, "bu": bl.clone()}

    return ScenarioProgram(
        name="aircond", num_scenarios=prod,
        base_seed=int(seed), start=int(start),
        template={"c": c, "A": A, "bl": bl0, "bu": bl0.copy(),
                  "l": l, "u": u},
        varying=("bl", "bu"), sampler=sampler,
        nonant_idx=nonant_idx,
        tree=make_tree(bfs),
    )


def make_tree(branching_factors=(3, 3, 2)) -> ScenarioTree:
    bfs = tuple(int(b) for b in branching_factors)
    return ScenarioTree(branching_factors=bfs,
                        nonants_per_stage=(2,) * len(bfs))


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"Scenario{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.add_to_config("branching_factors",
                      "branching factors, e.g. 3 3 2", list, [3, 3, 2])
    for name, default in (("mu_dev", 0.0), ("sigma_dev", 40.0),
                          ("start_seed", 1134)):
        cfg.add_to_config(name, f"aircond {name}", type(default), default)


def kw_creator(cfg):
    kw = {"branching_factors":
          tuple(cfg.get("branching_factors", (3, 3, 2)))}
    for name in ("mu_dev", "sigma_dev", "start_seed"):
        if cfg.get(name) is not None:
            kw[name] = cfg[name]
    return kw


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
