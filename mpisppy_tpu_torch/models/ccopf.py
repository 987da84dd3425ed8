###############################################################################
# ccopf: multistage (chance-constrained-style) optimal power flow on a
# scenario tree (port of mpisppy_tpu/models/ccopf.py; numpy only) — the
# acopf3 family (ref:examples/acopf3/ccopf_multistage.py + ACtree.py +
# fourstage.py), in TWO fidelities:
#
# DC mode (default) — the LINEARIZED B-theta power-flow model, the
# compiler-friendly stand-in for the reference's egret AC formulation:
#   stage t in {1,2,3}: dispatch g_{t,i}, angles theta_{t,b}, shed
#   slack u_{t,b} >= 0
#   rows: bus balance  sum_{i at b} g - sum_l B_l inc(l,b) dtheta = d_b(t)
#         line limits  |B_l (theta_from - theta_to)| <= cap_l
#   cost: c2 g^2 + c1 g (QUADRATIC — exercises the q path) + shed
#   nonants: g at stages 1 and 2 (stage-major, hydro's tree layout).
#
# SOC mode (soc=True) — the branch-flow second-order-cone relaxation of
# AC power flow (Baran-Wu DistFlow + the Farivar-Low SOCP relaxation)
# on a radial feeder, exercising the conic kernel contract
# (ops/cones.py) end to end.  Per stage, per line l (parent i -> child
# j): active/reactive flows P_l, Q_l, squared current i_l, squared
# voltages v_b, and the relaxed physics
#     v_j = v_i - 2(r P + x Q) + (r^2 + x^2) i_l        (voltage drop)
#     ||(2P_l, 2Q_l, i_l - v_i)||_2 <= i_l + v_i        (SOC block:
#         the convex relaxation of i_l v_i = P^2 + Q^2)
# with DistFlow bus balances (losses r i / x i charged to the parent
# side), shed slacks on BOTH balances, and a loss cost on i_l that
# drives the relaxation toward tightness.  Nonants stay g at stages
# 1 and 2, so the SOC workload drops into the same tree/cylinder
# plumbing as the DC one.
#
# Demand at stages 2/3 scales by seeded per-branch multipliers
# (ref:ACtree.py's per-node random demand scaling) in both modes.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.core.tree import ScenarioTree
from mpisppy_tpu_torch.utils.sputils import extract_num

_SHED = 500.0


def grid_instance(n_buses: int = 4, seed: int = 0) -> dict:
    """Small ring grid: one generator per bus except the last, lines
    ring-connected, quadratic gen costs."""
    rng = np.random.RandomState(seed)
    lines = [(b, (b + 1) % n_buses) for b in range(n_buses)]
    gens = list(range(max(1, n_buses - 1)))
    return {
        "n_buses": n_buses,
        "lines": lines,
        "B": rng.uniform(5.0, 15.0, size=len(lines)),
        "cap": rng.uniform(0.6, 1.2, size=len(lines)),
        "gens": gens,                      # bus index of each generator
        "gmax": rng.uniform(0.8, 1.6, size=len(gens)),
        "c1": rng.uniform(10.0, 30.0, size=len(gens)),
        "c2": rng.uniform(2.0, 6.0, size=len(gens)),
        "demand": rng.uniform(0.3, 0.7, size=n_buses),
    }


def feeder_instance(n_buses: int = 4, seed: int = 0) -> dict:
    """Radial feeder for the SOC (branch-flow) mode: a path of buses
    with line l feeding bus l+1 from bus l, per-line impedances r + jx,
    generators on the same buses as grid_instance."""
    rng = np.random.RandomState(seed)
    nl = n_buses - 1
    gens = list(range(max(1, n_buses - 1)))
    return {
        "n_buses": n_buses,
        "r": rng.uniform(0.01, 0.05, size=nl),
        "x": rng.uniform(0.02, 0.08, size=nl),
        "cap": rng.uniform(0.6, 1.2, size=nl),
        "gens": gens,
        "gmax": rng.uniform(0.8, 1.6, size=len(gens)),
        "c1": rng.uniform(10.0, 30.0, size=len(gens)),
        "c2": rng.uniform(2.0, 6.0, size=len(gens)),
        "demand": rng.uniform(0.15, 0.35, size=n_buses),
        "qfrac": 0.35,      # reactive demand fraction
        "loss_cost": 1.0,   # linear cost on i_l: drives the SOC tight
    }


def branch_multiplier(stage: int, branch: int, seed: int = 0) -> float:
    rng = np.random.RandomState(40_000 + 97 * stage + branch + seed)
    return float(rng.uniform(0.8, 1.25))


def _stage_multipliers(scenario_name: str, bfs, seed: int):
    if len(bfs) != 2:
        raise ValueError("ccopf is a 3-stage problem: two branching "
                         "factors (ref:examples/acopf3/fourstage.py is "
                         "the 4-stage variant of the same tree recipe)")
    snum = extract_num(scenario_name)
    b2, b3 = snum // bfs[1], snum % bfs[1]
    return {1: 1.0,
            2: branch_multiplier(2, b2, seed),
            3: branch_multiplier(3, b2 * bfs[1] + b3, seed)}


def _soc_scenario(scenario_name: str, inst: dict, mult: dict
                  ) -> ScenarioSpec:
    """Branch-flow SOC relaxation scenario (see the module header).
    Per-stage columns: [g, gq, P, Q, v, iL, up, uq]."""
    nb = inst["n_buses"]
    nl = nb - 1
    gens = inst["gens"]
    ng = len(gens)
    per = 2 * ng + 3 * nl + 3 * nb
    n = 3 * per

    def col(t, base, i):
        return (t - 1) * per + base + i

    off_g, off_gq = 0, ng
    off_P, off_Q = 2 * ng, 2 * ng + nl
    off_v = 2 * ng + 2 * nl
    off_i = off_v + nb
    off_up = off_i + nl
    off_uq = off_up + nb

    c = np.zeros(n)
    q = np.zeros(n)
    l = np.full(n, -np.inf)  # noqa: E741
    u = np.full(n, np.inf)
    for t in (1, 2, 3):
        for i in range(ng):
            c[col(t, off_g, i)] = inst["c1"][i]
            q[col(t, off_g, i)] = 2.0 * inst["c2"][i]
            l[col(t, off_g, i)] = 0.0
            u[col(t, off_g, i)] = inst["gmax"][i]
            l[col(t, off_gq, i)] = -inst["gmax"][i]
            u[col(t, off_gq, i)] = inst["gmax"][i]
        for li in range(nl):
            cap = inst["cap"][li]
            for off in (off_P, off_Q):
                l[col(t, off, li)] = -cap
                u[col(t, off, li)] = cap
            c[col(t, off_i, li)] = inst["loss_cost"]
            l[col(t, off_i, li)] = 0.0
            u[col(t, off_i, li)] = 8.0 * cap * cap
        l[col(t, off_v, 0)] = 1.0   # substation voltage (squared)
        u[col(t, off_v, 0)] = 1.0
        for b in range(1, nb):
            l[col(t, off_v, b)] = 0.81
            u[col(t, off_v, b)] = 1.21
        for b in range(nb):
            for off in (off_up, off_uq):
                c[col(t, off, b)] = _SHED
                l[col(t, off, b)] = 0.0
                u[col(t, off, b)] = 10.0

    rows, bl, bu, soc_blocks = [], [], [], []
    for t in (1, 2, 3):
        d = inst["demand"] * mult[t]
        dq = inst["qfrac"] * d
        # DistFlow balances: inflow (parent line minus its loss) + gen
        # + shed - outflow (child line) = demand; bus b's parent line is
        # b-1, its child line is b (path feeder)
        for kind, off_f, off_u_, loss, dem in (
                ("P", off_P, off_up, inst["r"], d),
                ("Q", off_Q, off_uq, inst["x"], dq)):
            for b in range(nb):
                r = np.zeros(n)
                for i, gb in enumerate(gens):
                    if gb == b:
                        r[col(t, off_g if kind == "P" else off_gq, i)] = 1.0
                if b > 0:
                    r[col(t, off_f, b - 1)] = 1.0
                    r[col(t, off_i, b - 1)] = -loss[b - 1]
                if b < nb - 1:
                    r[col(t, off_f, b)] = -1.0
                r[col(t, off_u_, b)] = 1.0
                rows.append(r)
                bl.append(float(dem[b]))
                bu.append(float(dem[b]))
        for li in range(nl):   # voltage drop (equality)
            rl, xl = inst["r"][li], inst["x"][li]
            r = np.zeros(n)
            r[col(t, off_v, li + 1)] = 1.0
            r[col(t, off_v, li)] = -1.0
            r[col(t, off_P, li)] = 2.0 * rl
            r[col(t, off_Q, li)] = 2.0 * xl
            r[col(t, off_i, li)] = -(rl * rl + xl * xl)
            rows.append(r)
            bl.append(0.0)
            bu.append(0.0)
        for li in range(nl):   # SOC block: ||(2P,2Q,i-v)|| <= i+v
            head = np.zeros(n)
            head[col(t, off_i, li)] = 1.0
            head[col(t, off_v, li)] = 1.0
            t1 = np.zeros(n)
            t1[col(t, off_P, li)] = 2.0
            t2 = np.zeros(n)
            t2[col(t, off_Q, li)] = 2.0
            t3 = np.zeros(n)
            t3[col(t, off_i, li)] = 1.0
            t3[col(t, off_v, li)] = -1.0
            r0 = len(rows)
            rows.extend([head, t1, t2, t3])
            bl.extend([0.0] * 4)
            bu.extend([0.0] * 4)
            soc_blocks.append(np.arange(r0, r0 + 4, dtype=np.int32))

    nonant_idx = np.concatenate([
        [col(1, off_g, i) for i in range(ng)],
        [col(2, off_g, i) for i in range(ng)]]).astype(np.int32)
    return ScenarioSpec(
        name=scenario_name, c=c, q=q, A=np.asarray(rows),
        bl=np.asarray(bl), bu=np.asarray(bu), l=l, u=u,
        nonant_idx=nonant_idx, soc_blocks=soc_blocks,
    )


def mpc_drift(demand: np.ndarray, step: int) -> np.ndarray:
    """Deterministic rolling-dispatch load drift for window `step`: a
    diurnal swing (period 24 decision epochs, ±20%) applied to the base
    demand — the ccopf analogue of uc's rolled profile (mpc/horizon.py).
    Pure in {demand, step}, so a resumed stream re-derives window k's
    data exactly."""
    return np.asarray(demand) * (
        1.0 + 0.2 * np.sin(2.0 * np.pi * step / 24.0))


def scenario_creator(scenario_name: str, instance: dict | None = None,
                     branching_factors=(3, 3), seed: int = 0,
                     soc: bool = False, mpc_step: int = -1,
                     **_ignored) -> ScenarioSpec:
    if mpc_step >= 0:
        # rolling window `mpc_step` (mpc/horizon.py): re-key the branch
        # multipliers per step (fresh uncertainty each epoch, still a
        # pure function of {seed, step}) and drift the load
        seed = seed + 7919 * int(mpc_step)
        inst = dict(instance) if instance is not None else \
            (feeder_instance() if soc else grid_instance())
        inst["demand"] = mpc_drift(inst["demand"], int(mpc_step))
        instance = inst
    bfs = tuple(int(b) for b in branching_factors)
    mult = _stage_multipliers(scenario_name, bfs, seed)
    if soc:
        return _soc_scenario(scenario_name,
                             instance or feeder_instance(), mult)
    inst = instance or grid_instance()

    nb = inst["n_buses"]
    lines = inst["lines"]
    gens = inst["gens"]
    nl, ng = len(lines), len(gens)
    # per-stage columns: [g (ng), theta (nb), shed (nb)]
    per = ng + nb + nb
    n = 3 * per

    def gcol(t, i):
        return (t - 1) * per + i

    def thcol(t, b):
        return (t - 1) * per + ng + b

    def ucol(t, b):
        return (t - 1) * per + ng + nb + b

    c = np.zeros(n)
    q = np.zeros(n)
    l = np.full(n, -np.inf)  # noqa: E741
    u = np.full(n, np.inf)
    for t in (1, 2, 3):
        for i in range(ng):
            c[gcol(t, i)] = inst["c1"][i]
            q[gcol(t, i)] = 2.0 * inst["c2"][i]  # q is the 1/2 x'Qx diag
            l[gcol(t, i)] = 0.0
            u[gcol(t, i)] = inst["gmax"][i]
        l[thcol(t, 0)] = 0.0     # reference bus
        u[thcol(t, 0)] = 0.0
        for b in range(1, nb):
            l[thcol(t, b)] = -np.pi
            u[thcol(t, b)] = np.pi
        for b in range(nb):
            c[ucol(t, b)] = _SHED
            l[ucol(t, b)] = 0.0
            u[ucol(t, b)] = 10.0

    rows, bl, bu = [], [], []
    for t in (1, 2, 3):
        d = inst["demand"] * mult[t]
        for b in range(nb):   # bus balance (equality)
            r = np.zeros(n)
            for i, gb in enumerate(gens):
                if gb == b:
                    r[gcol(t, i)] = 1.0
            for li, (f, to) in enumerate(lines):
                if f == b:
                    r[thcol(t, f)] -= inst["B"][li]
                    r[thcol(t, to)] += inst["B"][li]
                if to == b:
                    r[thcol(t, to)] -= inst["B"][li]
                    r[thcol(t, f)] += inst["B"][li]
            r[ucol(t, b)] = 1.0
            rows.append(r)
            bl.append(float(d[b]))
            bu.append(float(d[b]))
        for li, (f, to) in enumerate(lines):   # line limits
            r = np.zeros(n)
            r[thcol(t, f)] = inst["B"][li]
            r[thcol(t, to)] = -inst["B"][li]
            rows.append(r)
            bl.append(-float(inst["cap"][li]))
            bu.append(float(inst["cap"][li]))

    nonant_idx = np.concatenate([
        [gcol(1, i) for i in range(ng)],
        [gcol(2, i) for i in range(ng)]]).astype(np.int32)
    return ScenarioSpec(
        name=scenario_name, c=c, q=q, A=np.asarray(rows),
        bl=np.asarray(bl), bu=np.asarray(bu), l=l, u=u,
        nonant_idx=nonant_idx,
    )


def make_tree(branching_factors=(3, 3),
              instance: dict | None = None) -> ScenarioTree:
    # DC and SOC instances share the generator layout (feeder_instance
    # mirrors grid_instance's gens), so the tree — nonants are g at
    # stages 1 and 2 — is identical in both modes
    bfs = tuple(branching_factors)
    ng = len((instance or grid_instance())["gens"])
    return ScenarioTree(branching_factors=bfs,
                        nonants_per_stage=(ng, ng))


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"scen{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("branching_factors",
                      description="two branching factors, e.g. 3 3",
                      domain=list, default=[3, 3])
    cfg.add_to_config("soc",
                      description="solve the branch-flow second-order-"
                      "cone (conic AC relaxation) workload instead of "
                      "the DC approximation",
                      domain=bool, default=False)
    cfg.add_to_config("ccopf_mpc_step",
                      description="rolling-horizon window index: >= 0 "
                      "re-keys multipliers and drifts the load per step; "
                      "-1 = not a rolling window",
                      domain=int, default=-1)


def kw_creator(cfg):
    return {"branching_factors":
            tuple(cfg.get("branching_factors", (3, 3))),
            "soc": bool(cfg.get("soc", False)),
            "mpc_step": int(cfg.get("ccopf_mpc_step", -1))}


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
