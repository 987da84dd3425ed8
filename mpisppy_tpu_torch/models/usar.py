###############################################################################
# USAR: urban search and rescue team deployment under uncertainty (port
# of mpisppy_tpu/models/usar.py; numpy only; ref:examples/usar/abstract.py,
# the Chen & Miller-Hooks formulation; data generation follows ref:examples/usar/generate_data.py's shape:
# uniform coordinates, Poisson-ish household sizes, Pareto survival
# deadlines).
#
# Modeled here (the core decision structure):
#   * first stage: binary depot activation, sum_d active_d == K
#     (ref:abstract.py limit_num_active_depots) — the nonants;
#   * per scenario: timed departures depot_departures[t, d, s] (binary),
#     only from active depots (ref depart_only_active_depots), at most
#     depot_inflows[t] departures per period (ref limit_depot_outflow),
#     each site visited at most once (ref visit_only_once), and a
#     departure at t from d saves lives_to_be_saved[t + travel(d, s), s]
#     (deadline-limited: lives decay to 0 after the scenario's survival
#     horizon).
# Simplification vs the reference: teams return after one rescue —
# the inter-site chain variables (site_departures / stays_at_site /
# is_time_from_arrival) are folded into the single-hop arrival
# bookkeeping, keeping the same first-stage decision and the same
# deadline/capacity trade-offs while staying a compact batched spec.
#
# Columns: [active_d (D, int, nonants) | x_{t,d,s} (T*D*S, int)]
# Rows: activation equality, per-(t,d,s) linking x <= active_d,
#       per-t outflow caps, per-s visit-once.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num


def generate_instance(num_depots: int = 3, num_sites: int = 8,
                      time_horizon: int = 6, num_active_depots: int = 2,
                      seed: int = 0) -> dict:
    """Deterministic geometry (ref:generate_data.py generate_coords):
    uniform depot/site coordinates, travel times from scaled distances."""
    rng = np.random.RandomState(seed)
    depot_xy = rng.rand(num_depots, 2)
    site_xy = rng.rand(num_sites, 2)
    dist = np.linalg.norm(depot_xy[:, None, :] - site_xy[None, :, :],
                          axis=-1)
    travel = np.maximum(1, np.ceil(dist * (time_horizon / 2))).astype(int)
    return {
        "num_depots": num_depots,
        "num_sites": num_sites,
        "time_horizon": time_horizon,
        "num_active_depots": num_active_depots,
        "travel": travel,                      # (D, S) periods
        "depot_inflows": np.full(time_horizon, 2, int),
    }


def sample_scenario(inst: dict, scennum: int, seedoffset: int = 0):
    """(lives (T, S), deadline (S,)): household sizes ~ Poisson(2)+1,
    survival deadlines ~ scaled Pareto (ref:generate_data.py
    RESCUE_PARTY_SIZE / EMERGENCY_SUPPLIES_STOCK)."""
    T, S = inst["time_horizon"], inst["num_sites"]
    rng = np.random.RandomState(7_000 + scennum + seedoffset)
    sizes = rng.poisson(2.0, size=S) + 1
    deadline = np.minimum(T, np.ceil(
        (1.0 + rng.pareto(1.0, size=S)) * (T / 3.0))).astype(int)
    lives = np.zeros((T, S))
    for s in range(S):
        lives[:deadline[s], s] = sizes[s]
    return lives, deadline


def scenario_creator(scenario_name: str, instance: dict | None = None,
                     num_scens: int | None = None, seedoffset: int = 0,
                     lp_relax: bool = False, **_ignored) -> ScenarioSpec:
    inst = instance or generate_instance()
    scennum = extract_num(scenario_name)
    lives, _ = sample_scenario(inst, scennum, seedoffset)
    D, S, T = inst["num_depots"], inst["num_sites"], inst["time_horizon"]
    travel = inst["travel"]
    n = D + T * D * S

    def xcol(t, d, s):
        return D + (t * D + d) * S + s

    # objective: maximize saved lives -> minimize -lives at arrival time
    c = np.zeros(n)
    for t in range(T):
        for d in range(D):
            for s in range(S):
                ta = t + travel[d, s]
                if ta < T:
                    c[xcol(t, d, s)] = -lives[ta, s]
    l = np.zeros(n)  # noqa: E741
    u = np.ones(n)

    rows = []
    bl, bu = [], []
    # activation count (equality)
    r = np.zeros(n)
    r[:D] = 1.0
    rows.append(r)
    bl.append(float(inst["num_active_depots"]))
    bu.append(float(inst["num_active_depots"]))
    # linking: sum_t,s x_{t,d,s} <= T * inflow * active_d  (aggregated
    # big-M link; exact per-(t,d,s) links would be T*D*S rows — the
    # aggregate plus the outflow caps gives the same integer hull here
    # because inflow caps already bound per-period departures)
    for d in range(D):
        r = np.zeros(n)
        r[d] = -float(T * int(inst["depot_inflows"].max()))
        for t in range(T):
            for s in range(S):
                r[xcol(t, d, s)] = 1.0
        rows.append(r)
        bl.append(-np.inf)
        bu.append(0.0)
    # per-period outflow caps
    for t in range(T):
        r = np.zeros(n)
        for d in range(D):
            for s in range(S):
                r[xcol(t, d, s)] = 1.0
        rows.append(r)
        bl.append(-np.inf)
        bu.append(float(inst["depot_inflows"][t]))
    # visit each site at most once
    for s in range(S):
        r = np.zeros(n)
        for t in range(T):
            for d in range(D):
                r[xcol(t, d, s)] = 1.0
        rows.append(r)
        bl.append(-np.inf)
        bu.append(1.0)

    integer = np.ones(n, bool)
    if lp_relax:
        integer = np.zeros(n, bool)
    return ScenarioSpec(
        name=scenario_name, c=c, A=np.asarray(rows),
        bl=np.asarray(bl), bu=np.asarray(bu), l=l, u=u,
        nonant_idx=np.arange(D, dtype=np.int32),
        probability=None if num_scens is None else 1.0 / num_scens,
        integer=integer,
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
