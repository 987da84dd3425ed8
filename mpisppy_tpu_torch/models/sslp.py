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


# --------------------------------------------------------------------------
# Exact integer recourse evaluation (the inner-bound evaluator; port of
# the JAX package's models/sslp.py::exact_recourse_value and
# eval_candidates_exact).
#
# With the first stage fixed, a scenario's recourse is an assignment
# with capacity-overflow penalties.  The evaluator solves the recourse
# LP, rounds each present client to its argmax server (the client rows
# are SOS1-like equalities), then improves by 1-opt moves and swaps
# until stable.  The returned value is the exact objective of an
# integral feasible recourse, computed in closed form from the instance
# data.
# --------------------------------------------------------------------------
def exact_recourse_value(inst: dict, client_present: np.ndarray,
                         xhat: np.ndarray,
                         y_lp: np.ndarray | None = None) -> float:
    """One scenario's exact integer recourse value at first stage
    `xhat` ((n,) 0/1).  `y_lp` ((m, n) LP allocation, client-major)
    seeds the rounding; greedy best-revenue seeding is used without it.
    Serving from closed servers is allowed (original penalty-form
    semantics) but never chosen by the heuristic unless no server is
    open."""
    n = int(inst["NumServers"])
    m = int(inst["NumClients"])
    cap = float(inst["Capacity"])
    pen = float(inst.get("Penalty", DEFAULT_PENALTY))
    D = np.asarray(inst["Demand"], float)      # (m, n)
    R = np.asarray(inst["Revenue"], float)
    fc = np.asarray(inst["FixedCost"], float)
    x = np.round(np.asarray(xhat, float)[:n])
    open_j = np.nonzero(x > 0.5)[0]
    present = np.nonzero(np.asarray(client_present, float) > 0.5)[0]
    first = float(fc @ x)
    if present.size == 0:
        return first
    serve_set = open_j if open_j.size else np.arange(n)

    # seed assignment
    assign = np.empty(present.size, int)
    if y_lp is not None:
        for k, i in enumerate(present):
            assign[k] = serve_set[int(np.argmax(y_lp[i, serve_set]))]
    else:
        for k, i in enumerate(present):
            assign[k] = serve_set[int(np.argmax(R[i, serve_set]))]

    def value(assign):
        load = np.zeros(n)
        rev = 0.0
        for k, i in enumerate(present):
            j = assign[k]
            load[j] += D[i, j]
            rev += R[i, j]
        over = np.maximum(0.0, load - cap * x)
        return first - rev + pen * float(over.sum())

    best = value(assign)
    # 1-opt moves + pairwise swaps: single-client moves cannot fix
    # capacity packing (two clients on over-full servers may need to
    # trade places), so the sweep alternates move and swap passes
    improved = True
    sweeps = 0
    while improved and sweeps < 30:
        improved = False
        sweeps += 1
        for k in range(present.size):
            cur = assign[k]
            for j in serve_set:
                if j == cur:
                    continue
                trial = assign.copy()
                trial[k] = j
                v = value(trial)
                if v < best - 1e-9:
                    assign, best = trial, v
                    improved = True
        for k1 in range(present.size):
            for k2 in range(k1 + 1, present.size):
                if assign[k1] == assign[k2]:
                    continue
                trial = assign.copy()
                trial[k1], trial[k2] = assign[k2], assign[k1]
                v = value(trial)
                if v < best - 1e-9:
                    assign, best = trial, v
                    improved = True
    return best


def candidates_batch(inst: dict, client_presents: "list[np.ndarray]",
                     xhats, device=None):
    """(batch, qp) of eval_candidates_exact's one batched LP: the S
    scenarios repeated for each of the K candidates (K*S problems of
    one dense shared A), the nonants fixed through with_fixed_nonants.
    The batch lies on `device`, else on the device of `xhats` where it
    is a tensor, else on CUDA (core.batch.from_specs).

    As in the JAX package, the (K*S, N) candidate rows go to
    with_fixed_nonants, which reads a two-dimensional argument per tree
    node: on the two-stage tree every copy is fixed at candidate 0, and
    only the rounding's seed comes from that LP (ROADMAP C8)."""
    import torch

    from mpisppy_tpu_torch.core import batch as batch_mod

    if device is None and isinstance(xhats, torch.Tensor):
        device = xhats.device
    xh = np.asarray(xhats.cpu() if isinstance(xhats, torch.Tensor)
                    else xhats, float)
    S, K = len(client_presents), len(xh)
    specs = [_build_spec(inst, client_presents[s], f"p{k}_{s}", None)
             for k in range(K) for s in range(S)]
    # uniform pair probabilities keep from_specs happy; expectations are
    # taken per candidate by the caller
    for sp in specs:
        sp.probability = 1.0 / len(specs)
    b = batch_mod.from_specs(specs, device=device)
    fixed = torch.as_tensor(np.repeat(xh, S, axis=0), dtype=b.qp.c.dtype,
                            device=b.device)  # (K*S, n)
    return b, b.with_fixed_nonants(fixed)


def eval_candidates_exact(inst: dict, client_presents: "list[np.ndarray]",
                          xhats, probs=None, lp_opts=None,
                          device=None) -> "list[float]":
    """Exact integer inner-bound values E[f(xhat)] for several candidate
    first stages: one batched LP over the K*S recourse problems
    (candidates_batch: a dense shared A, so its windows run in the
    window kernel on CUDA tensors) seeds per-client argmax rounding +
    1-opt.  Returns one expectation per candidate."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg

    xh = np.asarray(xhats.cpu() if isinstance(xhats, torch.Tensor)
                    else xhats, float)
    S, K = len(client_presents), len(xh)
    n = int(inst["NumServers"])
    m = int(inst["NumClients"])
    if probs is None:
        probs = np.full(S, 1.0 / S)
    b, qp = candidates_batch(inst, client_presents, xhats, device)
    opts = lp_opts or pdhg.PDHGOptions(tol=1e-5, max_iters=20_000,
                                       restart_period=40, omega0=0.1)
    st = pdhg.solve(qp, opts, pdhg.init_state(qp, opts))
    # original-space allocation block, client-major (m, n) per problem
    x_orig = (st.x * torch.broadcast_to(b.d_col, (K * S, b.qp.n))) \
        .cpu().numpy()
    y_all = x_orig[:, n:n + m * n].reshape(K * S, m, n)
    out = []
    for k in range(K):
        tot = 0.0
        for s in range(S):
            tot += probs[s] * exact_recourse_value(
                inst, client_presents[s], xh[k], y_lp=y_all[k * S + s])
        out.append(float(tot))
    return out
