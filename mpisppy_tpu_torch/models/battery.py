###############################################################################
# battery: hybrid solar-battery storage (Singh-Knueven Lagrangian
# relaxation) as BoxQP scenario specs (port of
# mpisppy_tpu/models/battery.py; numpy and scipy;
# ref:examples/battery/battery.py:25-131).
#
#   first stage (nonants): y_t >= 0   hourly committed output, t=1..T
#   second stage:          p_t in [0,cMax] charge, q_t in [0,dMax]
#                          discharge, x_t in [eMin,eMax] storage,
#                          z in {0,1} chance-constraint indicator
#   storage balance:  x_{t+1} = x_t + eff p_t - (1/eff) q_t   (x_1 = x0)
#   big-M rows:       y_t - q_t + p_t - M_{s,t} z <= solar_{s,t}
#   objective:        -rev.y + char*sum p + disc*sum q + lam*z
#
# Randomness enters only through (solar, M) in the big-M RHS/column, so
# A is shared across the batch except the M column — the batch compiler
# keeps per-scenario A values with a shared ELL pattern.  `use_LP`
# relaxes z (the reference's LP mode); lam is the chance-constraint
# dual weight.  Data: the reference's published constants; solar from
# `solar_filename` (csv, scenarios x T) or a seeded synthetic profile.
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num

_DATA = {
    "T": 24, "eff": 0.9, "eMax": 960.0, "eMin": 192.0,
    "char": 0.0256, "disc": 0.0256, "cMax": 480.0, "dMax": 480.0,
    "eps": 0.05, "x0": 480.0,
    "rev": np.array(
        [0.0189, 0.0172, 0.0155, 0.0148, 0.0146, 0.0151, 0.0173, 0.0219,
         0.0227, 0.0226, 0.0235, 0.0242, 0.0250, 0.0261, 0.0285, 0.0353,
         0.0531, 0.0671, 0.0438, 0.0333, 0.0287, 0.0268, 0.0240, 0.0211]),
}


def synthetic_solar(num_scens: int, T: int = 24, seed: int = 0) -> np.ndarray:
    """(num_scens, T) seeded diurnal solar output."""
    rng = np.random.RandomState(seed)
    t = np.arange(T)
    base = 400.0 * np.clip(np.sin(np.pi * (t - 6.0) / 12.0), 0.0, None)
    scale = rng.uniform(0.4, 1.1, size=(num_scens, 1))
    noise = rng.uniform(0.85, 1.15, size=(num_scens, T))
    return base[None, :] * scale * noise


def getData(solar_filename: str | None = None, num_scens: int = 10,
            seed: int = 0) -> dict:
    """ref:battery.py:98-122 (constants from the paper; big-M from its
    Corollary 1 with all-equally-likely scenarios)."""
    data = dict(_DATA)
    if solar_filename is not None:
        data["solar"] = np.loadtxt(solar_filename, delimiter=",")
    else:
        data["solar"] = synthetic_solar(num_scens, data["T"], seed)
    N = data["solar"].shape[0]
    data["N"] = N
    base = min(data["dMax"], data["eff"] * (data["eMax"] - data["eMin"]))
    M = base * np.ones((N, data["T"])) - data["solar"]
    ell = int(np.floor(N * data["eps"]) + 1)
    M += np.sort(data["solar"], axis=0)[-ell, :]
    data["M"] = M
    return data


def scenario_creator(scenario_name: str, solar_filename: str | None = None,
                     use_LP: bool = False, lam: float = 100.0,
                     data: dict | None = None, num_scens: int | None = None,
                     seed: int = 0, **_ignored) -> ScenarioSpec:
    """Column layout: [y (T) | p (T) | q (T) | x (T) | z].
    Row layout: [T-1 balance eq | T big-M rows]."""
    if data is None:
        data = getData(solar_filename, num_scens or 10, seed)
    s = extract_num(scenario_name)
    T = data["T"]
    eff = data["eff"]
    solar = np.asarray(data["solar"], float)
    M = np.asarray(data["M"], float)
    Y0, P0, Q0, X0, Z0 = 0, T, 2 * T, 3 * T, 4 * T
    n = 4 * T + 1
    m = (T - 1) + T

    cache = data.get("_spec_cache")
    if cache is None:
        # deterministic structure shared across scenarios except the
        # big-M column, which carries scenario values — build the shared
        # parts once
        rows, cols, vals = [], [], []
        r = 0
        # T-1 balance rows over t=0..T-2, leaving the final hour's p/q
        # outside the storage recursion — this mirrors the REFERENCE
        # formulation exactly (ref:battery.py:65-68 iterates Tm1 =
        # range(T-1)); the end-of-horizon artifact is the paper
        # model's, kept for parity
        for t in range(T - 1):
            rows += [r, r, r, r]
            cols += [X0 + t + 1, X0 + t, P0 + t, Q0 + t]
            vals += [1.0, -1.0, -eff, 1.0 / eff]
            r += 1
        bigm0 = r
        for t in range(T):
            rows += [r, r, r, r]
            cols += [Y0 + t, Q0 + t, P0 + t, Z0]
            vals += [1.0, -1.0, 1.0, 0.0]  # M value filled per scenario
            r += 1
        c = np.concatenate([-np.asarray(data["rev"], float),
                            np.full(T, data["char"]),
                            np.full(T, data["disc"]),
                            np.zeros(T), [0.0]])
        l = np.concatenate([np.zeros(T), np.zeros(T), np.zeros(T),  # noqa: E741
                            np.full(T, data["eMin"]), [0.0]])
        u = np.concatenate([
            np.full(T, solar.max() + M.max() + data["dMax"]),
            np.full(T, data["cMax"]), np.full(T, data["dMax"]),
            np.full(T, data["eMax"]), [1.0]])
        l[X0] = u[X0] = data["x0"]         # initial storage level
        integer = np.zeros(n, bool)
        integer[Z0] = True
        cache = data["_spec_cache"] = (
            np.asarray(rows), np.asarray(cols), np.asarray(vals, float),
            bigm0, c, l, u, integer)
    rows, cols, vals, bigm0, c, l, u, integer = cache

    import scipy.sparse as sps
    vals_s = vals.copy()
    # the z entry of big-M row t is the 4th entry of each group of 4
    z_slots = np.nonzero(np.asarray(cols) == Z0)[0]
    vals_s[z_slots] = -M[s]
    A = sps.csr_matrix((vals_s, (rows, cols)), shape=(m, n))
    bl = np.concatenate([np.zeros(T - 1), np.full(T, -np.inf)])
    bu = np.concatenate([np.zeros(T - 1), solar[s]])

    c_s = c.copy()
    c_s[Z0] = lam
    return ScenarioSpec(
        name=scenario_name, c=c_s, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=np.arange(T, dtype=np.int32),
        probability=1.0 / data["N"],
        integer=np.zeros(n, bool) if use_LP else integer,
    )


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"scen{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("solar_filename", "csv of solar scenarios", str,
                      None)
    cfg.add_to_config("battery_lam", "chance-constraint dual weight",
                      float, 100.0)
    cfg.add_to_config("battery_use_lp", "relax the indicator z", bool,
                      False)


def kw_creator(cfg):
    ns = int(cfg["num_scens"])
    return {
        "data": getData(cfg.get("solar_filename"), ns),
        "num_scens": ns,
        "lam": cfg.get("battery_lam", 100.0),
        "use_LP": cfg.get("battery_use_lp", False),
    }


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
