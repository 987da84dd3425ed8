###############################################################################
# uc: stochastic unit commitment as sparse BoxQP scenario specs (port of
# mpisppy_tpu/models/uc.py; numpy and scipy, no Pyomo/egret).  The
# decision structure of the reference's egret UC models
# (ref:examples/uc/uc_funcs.py; paper runs
# ref:paperruns/larger_uc/uc_cylinders.py):
#
#   first stage  (nonant): commitment u_{g,t} in {0,1}, all hours
#   first stage  (implied): startup v_{g,t}, shutdown w_{g,t} in [0,1]
#   second stage:          dispatch p_{g,t} >= 0, load shed s_t >= 0,
#                          reserve shortfall r_t >= 0
#   gen limits:  Pmin_g u_{g,t} <= p_{g,t} <= Pmax_g u_{g,t}
#   balance:     sum_g p_{g,t} + s_t = d_t^scen
#   ramping:     |p_{g,t} - p_{g,t-1}| <= R_g
#   state:       u_{g,t} - u_{g,t-1} - v_{g,t} + w_{g,t} = 0  (u_{g,-1}=0)
#   min-up:      sum_{tau in (t-UT_g, t]} v_{g,tau} <= u_{g,t}
#   min-down:    sum_{tau in (t-DT_g, t]} w_{g,tau} <= 1 - u_{g,t}
#   reserve:     sum_g Pmax_g u_{g,t} + r_t >= (1+rho_r) d_t^scen
#   objective:   sum cfix_g u + cstart_g v + cvar_g p
#                + VOLL * s + CRSV * r
#
# Randomness is the hourly demand, d^scen = profile * (1 + AR(1) noise):
# only the balance and reserve right-hand sides vary, so the sparse
# constraint matrix is one shared ELL block for any scenario count.
# scenario_creator seeds the noise with numpy RandomState per scenario;
# scenario_program draws it from threefry keys (scengen).
#
# Not ported: the rolling-horizon hooks mpc_instance/_mpc_demand and
# the --uc-mpc-* flags (serving; ROADMAP queue A, item 13).
###############################################################################
from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num

_VOLL = 5000.0    # $/MWh unserved energy
_CRSV = 1100.0    # $/MWh reserve shortfall (well below VOLL)


def synthetic_instance(n_gens: int = 10, n_hours: int = 24,
                       seed: int = 0) -> dict:
    """Seeded fleet and demand profile (deterministic given the seed)."""
    rng = np.random.RandomState(seed)
    pmax = rng.uniform(50.0, 300.0, n_gens)
    return {
        "n_gens": n_gens,
        "n_hours": n_hours,
        "pmax": pmax,
        "pmin": 0.3 * pmax,
        "ramp": 0.35 * pmax,
        "cvar": rng.uniform(10.0, 40.0, n_gens),     # $/MWh
        "cfix": rng.uniform(300.0, 1200.0, n_gens),  # $/h committed
        # startup costs scale with unit size (cold-start heuristic)
        "cstart": rng.uniform(2.0, 8.0, n_gens) * pmax,
        # bigger units cycle slower
        "min_up": np.clip((pmax / 80.0).astype(int) + 1, 1, 8),
        "min_down": np.clip((pmax / 100.0).astype(int) + 1, 1, 6),
        "reserve_frac": 0.1,
        # diurnal profile peaking at ~70% of fleet capacity
        "profile": 0.5 * pmax.sum()
        * (1.0 + 0.35 * np.sin(2.0 * np.pi
                               * (np.arange(n_hours) - 6.0) / 24.0)),
        "seed": seed,
    }


def scenario_demand(inst: dict, scennum: int) -> np.ndarray:
    """Multiplicative AR(1) demand noise, seeded per scenario."""
    rng = np.random.RandomState(1_000_003 * (inst["seed"] + 1) + scennum)
    eps = np.zeros(inst["n_hours"])
    for t in range(inst["n_hours"]):
        eps[t] = (0.6 * eps[t - 1] if t else 0.0) + rng.normal(0.0, 0.05)
    return inst["profile"] * (1.0 + eps)


def _shared_structure(inst: dict):
    """(A, c, l, u, integer, nonant_idx, bal0, rsv0, m), independent of
    the scenario and cached on the instance dict, so the batch compiler
    sees one sparse A object for the whole batch.  Column layout
    (g-major time blocks):
      [0:nU)          u_{g,t} commitment        {0,1}   <- nonants
      [nU:2nU)        p_{g,t} dispatch          [0,Pmax]
      [2nU:2nU+T)     s_t load shed             [0,inf)
      [2nU+T:3nU+T)   v_{g,t} startup           [0,1]
      [3nU+T:4nU+T)   w_{g,t} shutdown          [0,1]
      [4nU+T:4nU+2T)  r_t reserve shortfall     [0,inf)
    """
    if "_spec_cache" in inst:
        return inst["_spec_cache"]
    G, T = inst["n_gens"], inst["n_hours"]
    nU = G * T
    U0, P0, S0 = 0, nU, 2 * nU
    V0, W0, R0 = 2 * nU + T, 3 * nU + T, 4 * nU + T
    n = 4 * nU + 2 * T

    rows, cols, vals = [], [], []
    r = 0
    # pmax: p - Pmax u <= 0 ; pmin: Pmin u - p <= 0
    for g in range(G):
        for t in range(T):
            rows += [r, r]
            cols += [P0 + g * T + t, U0 + g * T + t]
            vals += [1.0, -inst["pmax"][g]]
            r += 1
    for g in range(G):
        for t in range(T):
            rows += [r, r]
            cols += [U0 + g * T + t, P0 + g * T + t]
            vals += [inst["pmin"][g], -1.0]
            r += 1
    # balance rows (right-hand side varies per scenario)
    bal0 = r
    for t in range(T):
        for g in range(G):
            rows.append(r)
            cols.append(P0 + g * T + t)
            vals.append(1.0)
        rows.append(r)
        cols.append(S0 + t)
        vals.append(1.0)
        r += 1
    # ramping
    for g in range(G):
        for t in range(1, T):
            rows += [r, r]
            cols += [P0 + g * T + t, P0 + g * T + t - 1]
            vals += [1.0, -1.0]
            r += 1
            rows += [r, r]
            cols += [P0 + g * T + t - 1, P0 + g * T + t]
            vals += [1.0, -1.0]
            r += 1
    # commitment state logic: u_t - u_{t-1} - v_t + w_t = 0 (u_{-1} = 0)
    for g in range(G):
        for t in range(T):
            rows.append(r)
            cols.append(U0 + g * T + t)
            vals.append(1.0)
            if t > 0:
                rows.append(r)
                cols.append(U0 + g * T + t - 1)
                vals.append(-1.0)
            rows += [r, r]
            cols += [V0 + g * T + t, W0 + g * T + t]
            vals += [-1.0, 1.0]
            r += 1
    # min-up:  sum_{tau=max(0,t-UT+1)..t} v_tau - u_t <= 0
    for g in range(G):
        UT = int(inst["min_up"][g])
        for t in range(T):
            for tau in range(max(0, t - UT + 1), t + 1):
                rows.append(r)
                cols.append(V0 + g * T + tau)
                vals.append(1.0)
            rows.append(r)
            cols.append(U0 + g * T + t)
            vals.append(-1.0)
            r += 1
    # min-down: sum_{tau=max(0,t-DT+1)..t} w_tau + u_t <= 1
    for g in range(G):
        DT = int(inst["min_down"][g])
        for t in range(T):
            for tau in range(max(0, t - DT + 1), t + 1):
                rows.append(r)
                cols.append(W0 + g * T + tau)
                vals.append(1.0)
            rows.append(r)
            cols.append(U0 + g * T + t)
            vals.append(1.0)
            r += 1
    # spinning reserve: -sum_g Pmax_g u_{g,t} - r_t <= -(1+rho) d_t
    rsv0 = r
    for t in range(T):
        for g in range(G):
            rows.append(r)
            cols.append(U0 + g * T + t)
            vals.append(-inst["pmax"][g])
        rows.append(r)
        cols.append(R0 + t)
        vals.append(-1.0)
        r += 1
    m = r
    A = sps.csr_matrix((vals, (rows, cols)), shape=(m, n))

    c = np.zeros(n)
    for g in range(G):
        c[U0 + g * T:U0 + (g + 1) * T] = inst["cfix"][g]
        c[P0 + g * T:P0 + (g + 1) * T] = inst["cvar"][g]
        c[V0 + g * T:V0 + (g + 1) * T] = inst["cstart"][g]
    c[S0:S0 + T] = _VOLL
    c[R0:R0 + T] = _CRSV

    l = np.zeros(n)  # noqa: E741
    u = np.ones(n)
    for g in range(G):
        u[P0 + g * T:P0 + (g + 1) * T] = inst["pmax"][g]
    u[S0:S0 + T] = inst["profile"].max() * 2.0   # shed <= any demand
    u[R0:R0 + T] = inst["pmax"].sum()            # shortfall <= requirement

    integer = np.zeros(n, bool)
    integer[U0:U0 + nU] = True
    nonant_idx = np.arange(nU, dtype=np.int32)
    inst["_spec_cache"] = (A, c, l, u, integer, nonant_idx, bal0, rsv0, m)
    return inst["_spec_cache"]


def _bound_skeleton(inst: dict, bal0: int, m: int):
    """(bl, bu) of every row but the demand rows (balance, reserve)."""
    G, T = inst["n_gens"], inst["n_hours"]
    bl = np.full(m, -np.inf)
    bu = np.zeros(m)
    rr = bal0 + T
    for g in range(G):                       # ramp rows: <= R_g
        bu[rr:rr + 2 * (T - 1)] = inst["ramp"][g]
        rr += 2 * (T - 1)
    nU = G * T
    bl[rr:rr + nU] = 0.0                     # state rows: == 0
    md0 = rr + nU + nU                       # min-up rows stay <= 0
    bu[md0:md0 + nU] = 1.0                   # min-down rows: <= 1
    return bl, bu


def scenario_creator(scenario_name: str, instance: dict | None = None,
                     num_scens: int | None = None, lp_relax: bool = True,
                     n_gens: int = 10, n_hours: int = 24, seed: int = 0,
                     **_ignored) -> ScenarioSpec:
    """Zero-based Scenario<k> names (ref:examples/uc convention)."""
    if instance is None:
        instance = synthetic_instance(n_gens, n_hours, seed)
    A, c, l, u, integer, nonant_idx, bal0, rsv0, m = \
        _shared_structure(instance)  # noqa: E741
    T = instance["n_hours"]
    d = scenario_demand(instance, extract_num(scenario_name))
    bl, bu = _bound_skeleton(instance, bal0, m)
    bl[bal0:bal0 + T] = d
    bu[bal0:bal0 + T] = d
    # reserve rows: -cap - r <= -(1 + rho) d
    bu[rsv0:rsv0 + T] = -(1.0 + instance["reserve_frac"]) * d
    integer_eff = integer if not lp_relax else np.zeros_like(integer)
    return ScenarioSpec(
        name=scenario_name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=nonant_idx,
        probability=None if num_scens is None else 1.0 / num_scens,
        integer=integer_eff,
    )


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"Scenario{i}" for i in range(start, start + num_scens)]


# --------------------------------------------------------------------------
# Seeded scenario synthesis (scengen branch).  The AR(1) noise
# eps_t = 0.6 eps_{t-1} + z_t is the lower-triangular weight sum
# eps = sum_j 0.6^(t-j) z_j over i.i.d. threefry normals z (f32, the
# JAX package's jax.random.normal bit for bit), elementwise ops only.
# --------------------------------------------------------------------------
def scenario_program(num_scens: int, seed: int = 0, start: int = 0,
                     n_gens: int = 10, n_hours: int = 24,
                     inst_seed: int = 0, lp_relax: bool = True,
                     instance: dict | None = None):
    """ScenarioProgram drawing the demand path through scengen keys."""
    import torch

    from mpisppy_tpu_torch.scengen import random as rnd
    from mpisppy_tpu_torch.scengen.program import ScenarioProgram, scen_key

    inst = instance if instance is not None \
        else synthetic_instance(n_gens, n_hours, inst_seed)
    A, c, l, u, integer, nonant_idx, bal0, rsv0, m = \
        _shared_structure(inst)  # noqa: E741
    T = inst["n_hours"]
    bl0, bu0 = _bound_skeleton(inst, bal0, m)
    t_ix = np.arange(T)
    W_ar = np.where(t_ix[None, :] <= t_ix[:, None],
                    0.6 ** (t_ix[:, None] - t_ix[None, :]), 0.0)
    rsv_fac = float(1.0 + inst["reserve_frac"])

    def f32(v, dev):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    def sampler(base_key, idx):
        dev = base_key.device
        z = rnd.normal(scen_key(base_key, idx), (T,)) * 0.05   # (k, T)
        eps = torch.sum(f32(W_ar, dev) * z[..., None, :], dim=-1)
        d = f32(inst["profile"], dev) * (1.0 + eps)
        k = d.shape[0]
        bl = f32(bl0, dev).expand(k, m).clone()
        bu = f32(bu0, dev).expand(k, m).clone()
        bl[:, bal0:bal0 + T] = d
        bu[:, bal0:bal0 + T] = d
        bu[:, rsv0:rsv0 + T] = -rsv_fac * d
        return {"bl": bl, "bu": bu}

    integer_eff = np.zeros_like(integer) if lp_relax else integer
    return ScenarioProgram(
        name="uc", num_scenarios=int(num_scens),
        base_seed=int(seed), start=int(start),
        template={"c": c, "A": A, "bl": bl0, "bu": bu0, "l": l, "u": u},
        varying=("bl", "bu"), sampler=sampler,
        nonant_idx=np.asarray(nonant_idx, np.int32),
        integer=integer_eff,
    )


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("uc_n_gens", "number of thermal units", int, 10)
    cfg.add_to_config("uc_n_hours", "scheduling horizon (hours)", int, 24)
    cfg.add_to_config("uc_seed", "instance seed", int, 0)


def kw_creator(cfg):
    instance = synthetic_instance(cfg.get("uc_n_gens", 10),
                                  cfg.get("uc_n_hours", 24),
                                  cfg.get("uc_seed", 0))
    return {
        "instance": instance,
        "num_scens": int(cfg["num_scens"]),
        "lp_relax": True,
    }


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
