###############################################################################
# SSLP: SIPLIB stochastic server location problem as BoxQP scenario specs
# (port of mpisppy_tpu/models/sslp.py; numpy only).  Semantics follow
# the reference model (ref:examples/sslp/model/ReferenceModel.py,
# ref:examples/sslp/sslp.py:27-60):
#
#   first stage:   FacilityOpen[j], j=1..n servers   (binary; the nonants)
#   second stage:  Allocation[i,j] (binary), Dummy[j] >= 0 (overflow)
#   constraints:   capacity:  sum_i Demand[i,j]*y_ij - d_j - Cap*x_j <= 0
#                  client:    sum_j y_ij == ClientPresent_i   (random RHS)
#   objective:     sum_j FixedCost_j x_j + Penalty*sum_j d_j
#                  - sum_ij Revenue_ij y_ij
#
# Randomness is RHS-only (ClientPresent), so the constraint matrix is
# deterministic and shared across the batch: one (m, n) A for any
# scenario count.  Data comes from SIPLIB ScenarioK.dat files
# (`data_dir`) or from a seeded synthetic instance (Ntaimo & Sen ranges).
# `strengthen` adds the y_ij <= x_j rows and ships A sparse (ELL).
###############################################################################
from __future__ import annotations

import os
import re

import numpy as np

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num

DEFAULT_PENALTY = 1000.0

# data_dir -> the first parsed scenario's dict, reused as the shared
# deterministic-instance carrier for _build_spec's cache (see below)
_DATA_DIR_CACHE: dict[str, dict] = {}


# --------------------------------------------------------------------------
# AMPL .dat parsing (the subset SIPLIB sslp files use: scalar params,
# indexed-list params, and table params).
# --------------------------------------------------------------------------
def parse_dat(path: str) -> dict:
    """Parse an sslp AMPL-format .dat file into plain python/numpy data."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"#.*", "", text)
    out: dict = {}
    # Each statement ends with ';'
    for stmt in text.split(";"):
        stmt = stmt.strip()
        if not stmt.startswith("param"):
            continue
        body = stmt[len("param"):].strip()
        if ":=" in body and ":" in body.split(":=")[0]:
            # table form: "Name:\n  col1 col2 ... :=\n row v v v ..."
            name, rest = body.split(":", 1)
            name = name.strip()
            header, data = rest.split(":=", 1)
            cols = [int(tok) for tok in header.split()]
            rows: dict[int, list[float]] = {}
            toks = data.split()
            i = 0
            while i < len(toks):
                r = int(toks[i])
                vals = [float(v) for v in toks[i + 1:i + 1 + len(cols)]]
                rows[r] = vals
                i += 1 + len(cols)
            nr, nc = max(rows), max(cols)
            mat = np.zeros((nr, nc))
            for r, vals in rows.items():
                for cix, v in zip(cols, vals):
                    mat[r - 1, cix - 1] = v
            out[name] = mat
        else:
            name, data = body.split(":=", 1)
            name = name.strip()
            toks = data.split()
            if len(toks) == 1:
                out[name] = float(toks[0])
            else:
                idx = [int(t) for t in toks[0::2]]
                vals = [float(t) for t in toks[1::2]]
                vec = np.zeros(max(idx))
                for i_, v in zip(idx, vals):
                    vec[i_ - 1] = v
                out[name] = vec
    return out


# --------------------------------------------------------------------------
# Synthetic SIPLIB-style instances (seeded, reproducible).
# --------------------------------------------------------------------------
def synthetic_instance(n_servers: int, n_clients: int, seed: int = 0) -> dict:
    """Deterministic instance data following the SIPLIB generation ranges."""
    rng = np.random.RandomState(seed)
    demand = rng.randint(0, 26, size=(n_clients, n_servers)).astype(float)
    inst = {
        "NumServers": float(n_servers),
        "NumClients": float(n_clients),
        "FixedCost": rng.randint(40, 71, size=n_servers).astype(float),
        # SIPLIB instances use Revenue == Demand
        "Revenue": demand,
        "Demand": demand,
        # capacity sized so a handful of servers can cover expected demand
        "Capacity": float(
            np.ceil(1.5 * demand.mean() * n_clients / max(2, n_servers // 2))),
        "Penalty": DEFAULT_PENALTY,
    }
    return inst


def synthetic_client_present(n_clients: int, scennum: int,
                             seedoffset: int = 0) -> np.ndarray:
    """ClientPresent ~ Bernoulli(1/2) per client, seeded per scenario."""
    rng = np.random.RandomState(10_000 + scennum + seedoffset)
    return (rng.rand(n_clients) < 0.5).astype(float)


# --------------------------------------------------------------------------
# Scenario compiler: instance data + ClientPresent -> ScenarioSpec.
# Column layout (n = NumServers, m = NumClients):
#   [0:n)        x_j FacilityOpen     [0,1] int   <- nonants
#   [n:n+m*n)    y_ij Allocation      [0,1] int   (i-major: y[i,j])
#   [n+m*n: +n)  d_j Dummy            [0,inf)
# Row layout:
#   [0:n)        capacity rows:  sum_i D_ij y_ij - d_j - Cap x_j <= 0
#   [n:n+m)      client rows:    sum_j y_ij == h_i
# --------------------------------------------------------------------------
def _build_spec(inst: dict, client_present: np.ndarray,
                name: str, probability: float | None,
                strengthen: bool = False) -> ScenarioSpec:
    n = int(inst["NumServers"])
    m = int(inst["NumClients"])
    cache_key = "_spec_cache_vub" if strengthen else "_spec_cache"

    # The deterministic data (A, c, box, integrality) is identical for
    # every scenario of an instance — build it once and share the SAME
    # numpy objects across specs, so a 100k-scenario build costs O(m*n)
    # host memory, not O(S*m*n), and the batch compiler's shared-A
    # detection hits the identity fast path.
    cache = inst.get(cache_key)
    if cache is None:
        cap = float(inst["Capacity"])
        penalty = float(inst.get("Penalty", DEFAULT_PENALTY))
        D = np.asarray(inst["Demand"], float)        # (m, n)
        R = np.asarray(inst["Revenue"], float)       # (m, n)
        fc = np.asarray(inst["FixedCost"], float)    # (n,)

        ncols = n + m * n + n
        nrows = n + m

        c = np.concatenate([fc, -R.reshape(-1), np.full(n, penalty)])

        A = np.zeros((nrows, ncols))
        # capacity rows (one per server j)
        j = np.arange(n)
        A[j, j] = -cap                               # -Cap * x_j
        for jj in range(n):
            A[jj, n + jj:n + m * n:n] = D[:, jj]     # D_ij y_ij (i-major)
        A[j, n + m * n + j] = -1.0                   # -d_j

        l = np.zeros(ncols)  # noqa: E741
        # d_j only absorbs D·y_j - Cap x_j <= sum_i D_ij, so the natural
        # finite bound is the column demand sum
        u = np.concatenate([np.ones(n + m * n), D.sum(axis=0)])

        # client rows (one per client i): sum_j y_ij == h_i
        for i in range(m):
            A[n + i, n + i * n:n + (i + 1) * n] = 1.0

        integer = np.zeros(ncols, bool)
        integer[:n + m * n] = True
        if strengthen:
            # variable-upper-bound rows y_ij <= x_j: valid for every
            # integer point, they cut fractional LP points where a barely
            # open server serves clients.  Two nonzeros a row, so the
            # strengthened matrix goes out sparse (ELL).
            import scipy.sparse as sps
            V = np.zeros((m * n, ncols))
            rows = np.arange(m * n)
            V[rows, n + rows] = 1.0                  # +y_ij
            V[rows, np.tile(np.arange(n), m)] = -1.0  # -x_j (i-major y)
            A = sps.csr_matrix(np.vstack([A, V]))
        cache = inst[cache_key] = (A, c, l, u, integer)
    A, c, l, u, integer = cache

    nrows = A.shape[0]
    bl = np.full(nrows, -np.inf)
    bu = np.full(nrows, np.inf)
    bu[:n] = 0.0
    bl[n:n + m] = client_present
    bu[n:n + m] = client_present
    if strengthen:
        bu[n + m:] = 0.0  # y_ij - x_j <= 0

    return ScenarioSpec(
        name=name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=np.arange(n, dtype=np.int32),
        probability=probability, integer=integer,
    )


def scenario_creator(scenario_name: str, data_dir: str | None = None,
                     instance: dict | None = None,
                     n_servers: int = 5, n_clients: int = 25,
                     num_scens: int | None = None,
                     seedoffset: int = 0, inst_seed: int = 0,
                     lp_relax: bool = False,
                     strengthen: bool = False) -> ScenarioSpec:
    """ref:examples/sslp/sslp.py:27-45 semantics: one spec per scenario;
    `data_dir` points at SIPLIB scenariodata; otherwise synthetic.
    `lp_relax` drops the integrality mask (the BASELINE 'sslp LP-relaxed'
    configs), so xhat heuristics do not round.  `strengthen` adds the
    y_ij <= x_j variable-upper-bound rows (a sparse A)."""
    if data_dir is not None:
        data = parse_dat(os.path.join(data_dir, scenario_name + ".dat"))
        h = np.zeros(int(data["NumClients"]))
        cp = data.get("ClientPresent")
        if cp is not None:
            cp = np.asarray(cp, float).reshape(-1)
            h[:cp.shape[0]] = cp
        else:
            h[:] = 1.0  # AMPL default=1 (ReferenceModel.py ClientPresent)
        # The deterministic data repeats in every ScenarioK.dat — route
        # all scenarios of a directory through ONE cached inst dict so
        # _build_spec's shared-(A,c,…) cache actually hits and the batch
        # compiler sees identical array objects (one (m,n) A on the host
        # regardless of scenario count).
        inst = _DATA_DIR_CACHE.setdefault(data_dir, data)
    else:
        if instance is None:
            instance = synthetic_instance(n_servers, n_clients, inst_seed)
        h = synthetic_client_present(int(instance["NumClients"]),
                                     extract_num(scenario_name), seedoffset)
    prob = None if num_scens is None else 1.0 / num_scens
    spec = _build_spec(inst if data_dir is not None else instance, h,
                       scenario_name, prob, strengthen=strengthen)
    if lp_relax:
        spec.integer = np.zeros_like(spec.integer)  # shared: don't mutate
    return spec


def scenario_names_creator(num_scens: int, start: int | None = None):
    """One-based names (ref:examples/sslp/sslp.py:55-60)."""
    start = 1 if start is None else start
    return [f"Scenario{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.add_to_config("instance_name",
                      description="sslp instance name (e.g., sslp_15_45_10)",
                      domain=str, default=None)
    cfg.add_to_config("sslp_data_path",
                      description="path to sslp data (e.g., ./data)",
                      domain=str, default=None)
    cfg.add_to_config("n_servers", description="synthetic servers",
                      domain=int, default=5)
    cfg.add_to_config("n_clients", description="synthetic clients",
                      domain=int, default=25)
    cfg.add_to_config("sslp_lp_relax",
                      description="drop the integrality mask (the "
                      "'sslp LP-relaxed' configuration)",
                      domain=bool, default=False)


def kw_creator(cfg):
    lp_relax = bool(cfg.get("sslp_lp_relax", False))
    inst = cfg.get("instance_name")
    if inst is not None and cfg.get("sslp_data_path") is not None:
        ns = int(inst.split("_")[-1])
        data_dir = os.path.join(cfg["sslp_data_path"], inst, "scenariodata")
        return {"data_dir": data_dir, "num_scens": ns,
                "lp_relax": lp_relax}
    # build the synthetic instance ONCE and share it across every
    # scenario_creator call: from_specs then finds one constraint matrix
    # (its identity fast path) and the batch takes the window kernel
    return {"instance": synthetic_instance(cfg.get("n_servers", 5),
                                           cfg.get("n_clients", 25)),
            "num_scens": cfg.get("num_scens"),
            "lp_relax": lp_relax}


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass


# --------------------------------------------------------------------------
# Seeded scenario synthesis (scengen branch; port of the JAX package's
# models/sslp.py::scenario_program).
#
# sslp randomness is RHS-only (ClientPresent), so the program's varying
# fields are just (bl, bu): the dense constraint matrix, costs and box
# stay one shared template for any scenario count.  ClientPresent ~
# Bernoulli(1/2) per client is drawn from threefry
# (uniform(scen_key(base_key, s)) < 0.5) instead of the RandomState
# stream of scenario_creator.  The rule is stated once, as RowDraws: the
# sampler is built from it, and the window kernel draws it in-kernel
# (scengen.window_inputs).
# --------------------------------------------------------------------------
def scenario_program(num_scens: int, seed: int = 0, start: int = 0,
                     n_servers: int = 5, n_clients: int = 25,
                     inst_seed: int = 0, lp_relax: bool = False,
                     instance: dict | None = None):
    """ScenarioProgram drawing ClientPresent through scengen keys."""
    from mpisppy_tpu_torch.scengen.program import RowDraws, ScenarioProgram

    inst = instance if instance is not None \
        else synthetic_instance(n_servers, n_clients, inst_seed)
    n = int(inst["NumServers"])
    m = int(inst["NumClients"])
    # populate the deterministic-structure cache and reuse its arrays
    _build_spec(inst, np.zeros(m), "_scengen_template", None)
    A, c, l, u, integer = inst["_spec_cache"]  # noqa: E741
    nrows = A.shape[0]

    bl0 = np.full(nrows, -np.inf)
    bu0 = np.full(nrows, np.inf)
    bu0[:n] = 0.0
    # ClientPresent rows n..n+m: bl = bu = 1.0 if u < 0.5 else 0.0
    draws = RowDraws(fields=("bl", "bu"), row0=n, count=m, threshold=0.5,
                     below=1.0, above=0.0)

    integer_eff = np.zeros_like(integer) if lp_relax else integer
    return ScenarioProgram(
        name="sslp", num_scenarios=int(num_scens),
        base_seed=int(seed), start=int(start),
        template={"c": c, "A": A, "bl": bl0, "bu": bu0, "l": l, "u": u},
        varying=("bl", "bu"),
        sampler=draws.as_sampler({"bl": bl0, "bu": bu0}),
        nonant_idx=np.arange(n, dtype=np.int32),
        integer=integer_eff, row_draws=draws,
    )
