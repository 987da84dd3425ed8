###############################################################################
# netdes: stochastic fixed-charge network design as sparse BoxQP
# scenario specs (port of mpisppy_tpu/models/netdes.py; numpy and
# scipy).  Matches the reference model semantics (ref:examples/netdes/netdes.py:24-80):
#
#   first stage:   x_e in {0,1}  build arc e           (cost c_e)
#   second stage:  y_e >= 0      flow on arc e         (cost d_e)
#   vub:           y_e - u_e x_e <= 0                  per arc
#   balance:       sum_out y - sum_in y = b_i          per node
#   randomness:    (d, u, b) per scenario.
#
# Instances come from the reference's NETGEN-style .dat files
# (ref:examples/netdes/data/network-*.dat, parsed here natively) or from
# a seeded synthetic generator with the same structure.  Constraint
# matrices are scipy-sparse; from_specs lowers them to a batched ELL
# block (vub rows carry scenario-dependent u_e), so the device holds
# O(S * nnz) instead of O(S * m * n).
###############################################################################
from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils.sputils import extract_num


def parse_dat(path: str) -> dict:
    """Parse a reference-format netdes .dat instance
    (ref:examples/netdes/netdes.py uses the `parse` helper; the format is
    header comments, then n, density, fixed/variable ratio, adjacency,
    first-stage cost matrix, K, probabilities, then (d, u, b) per
    scenario)."""
    import re
    numline = re.compile(r"^[\s0-9eE+\-.,;]+$")
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and numline.match(line) and any(ch.isdigit()
                                                    for ch in line):
                rows.append(line)

    def mat(s):
        return np.array([[float(v) for v in r.split(",")]
                         for r in s.split(";")])

    n = int(float(rows[0]))
    adj = mat(rows[3])
    c = mat(rows[4])
    K = int(float(rows[5]))
    p = np.array([float(v) for v in rows[6].split(",")])
    scens = []
    for k in range(K):
        d = mat(rows[7 + 3 * k])
        u = mat(rows[8 + 3 * k])
        b = np.array([float(v) for v in rows[9 + 3 * k].split(",")])
        scens.append({"d": d, "u": u, "b": b})
    assert adj.shape == (n, n) and len(p) == K
    return {"n": n, "adj": adj, "c": c, "p": p, "scens": scens}


def synthetic_instance(n_nodes: int = 10, num_scens: int = 10,
                       density: float = 0.6, seed: int = 0) -> dict:
    """Seeded instance with the reference .dat structure: one source
    (node 0), one sink (node 1), random arc costs/capacities/demands."""
    rng = np.random.RandomState(seed)
    adj = (rng.rand(n_nodes, n_nodes) < density).astype(float)
    np.fill_diagonal(adj, 0.0)
    # guarantee connectivity source->sink through a random path
    perm = [0] + list(rng.permutation(np.arange(2, n_nodes))) + [1]
    for a, b in zip(perm[:-1], perm[1:]):
        adj[a, b] = 1.0
    c = np.where(adj > 0, rng.uniform(6000, 16000, adj.shape), 0.0)
    p = rng.dirichlet(np.ones(num_scens))
    flow = rng.uniform(10, 16)
    scens = []
    for _ in range(num_scens):
        d = np.where(adj > 0, rng.uniform(15, 80, adj.shape), 0.0)
        u = np.where(adj > 0, rng.uniform(2 * flow / 3, 6 * flow,
                                          adj.shape), 0.0)
        b = np.zeros(n_nodes)
        # balance is out - in == b_i: node 0 (source, start of the
        # forced 0->...->1 path) supplies +flow, node 1 (sink) -flow
        b[0], b[1] = flow, -flow
        scens.append({"d": d, "u": u, "b": b})
    return {"n": n_nodes, "adj": adj, "c": c, "p": p, "scens": scens}


def _edges(adj: np.ndarray) -> list[tuple[int, int]]:
    return [(i, j) for i in range(adj.shape[0])
            for j in range(adj.shape[1]) if adj[i, j] > 0]


def scenario_creator(scenario_name: str, path: str | None = None,
                     instance: dict | None = None,
                     lp_relax: bool = False, **_ignored) -> ScenarioSpec:
    """Zero-based Scenario<k> names (ref:examples/netdes/netdes.py:87-96).

    Columns: x[0:E] (build, binary), y[E:2E] (flow).  Rows: E vub rows
    then n balance rows, as scipy-sparse (shared pattern across
    scenarios; values vary with u)."""
    if instance is None:
        if path is None:
            raise RuntimeError(
                "netdes needs `path` (a reference-format .dat) or a "
                "prebuilt `instance` (ref:netdes.py:25-28 semantics)")
        cache_key = "_netdes_cache"
        instance = scenario_creator.__dict__.setdefault(
            cache_key, {})
        if path not in instance:
            scenario_creator.__dict__[cache_key][path] = parse_dat(path)
        instance = scenario_creator.__dict__[cache_key][path]
    k = extract_num(scenario_name)
    sc = instance["scens"][k]
    adj, cmat = instance["adj"], instance["c"]
    n_nodes = instance["n"]
    edges = _edges(adj)
    E = len(edges)
    n = 2 * E

    c = np.zeros(n)
    for e, (i, j) in enumerate(edges):
        c[e] = cmat[i, j]
        c[E + e] = sc["d"][i, j]

    rows, cols, vals = [], [], []
    bl = np.full(E + n_nodes, -np.inf)
    bu = np.full(E + n_nodes, np.inf)
    # vub rows: y_e - u_e x_e <= 0
    for e, (i, j) in enumerate(edges):
        rows += [e, e]
        cols += [E + e, e]
        vals += [1.0, -sc["u"][i, j]]
        bu[e] = 0.0
    # balance rows: out - in == b_i
    for e, (i, j) in enumerate(edges):
        rows += [E + i, E + j]
        cols += [E + e, E + e]
        vals += [1.0, -1.0]
    for i in range(n_nodes):
        bl[E + i] = bu[E + i] = sc["b"][i]
    A = sps.csr_matrix((vals, (rows, cols)), shape=(E + n_nodes, n))

    l = np.zeros(n)  # noqa: E741
    u = np.concatenate([np.ones(E),
                        np.array([max(s["u"][i, j] for s in
                                      instance["scens"])
                                  for (i, j) in edges])])
    integer = np.zeros(n, bool)
    if not lp_relax:
        integer[:E] = True

    return ScenarioSpec(
        name=scenario_name, c=c, A=A, bl=bl, bu=bu, l=l, u=u,
        nonant_idx=np.arange(E, dtype=np.int32),
        probability=float(instance["p"][k]),
        integer=integer,
    )


def scenario_names_creator(num_scens: int, start: int | None = None):
    start = 0 if start is None else start
    return [f"Scenario{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.add_to_config("instance_name",
                      "netdes instance name (e.g. network-10-20-L-01)",
                      str, None)
    cfg.add_to_config("netdes_data_path", "path to netdes .dat data",
                      str, None)


def kw_creator(cfg):
    path = None
    if cfg.get("netdes_data_path") and cfg.get("instance_name"):
        path = f"{cfg['netdes_data_path']}/{cfg['instance_name']}.dat"
    kw = {"lp_relax": True}
    if path is not None:
        kw["path"] = path
        kw["num_scens"] = len(parse_dat(path)["scens"])
    else:
        num = cfg.get("num_scens") or 10
        kw["instance"] = synthetic_instance(num_scens=int(num))
        kw["num_scens"] = int(num)
    return kw


def scenario_denouement(rank, scenario_name, spec, x=None):
    pass
