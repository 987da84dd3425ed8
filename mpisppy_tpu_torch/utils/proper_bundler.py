###############################################################################
# Proper bundles (port of mpisppy_tpu/utils/proper_bundler.py;
# ref:mpisppy/utils/proper_bundler.py:29-120).
#
# A "proper bundle" replaces k scenarios by ONE subproblem — their
# extensive form with the within-bundle nonanticipativity built in.
# The reference forms a Pyomo EF per bundle (sputils.create_EF) whose
# reference variables become the bundle's nonants; here the bundle spec
# shares ONE set of nonant columns across members and block-concatenates
# the second-stage columns/rows:
#
#   columns: [x_non (N, shared)] ++ [member i's other columns]_i
#   rows:    member i's rows with its nonant columns remapped to the
#            shared block (a scipy CSR matrix per bundle; from_specs
#            turns distinct sparse A objects into one ELL matrix with
#            batched values, so a bundle wheel runs the plain ELL
#            iteration and no window kernel, as in the JAX package)
#   c, q:    weighted by the member's conditional probability p_i/p_bun
#            (so p_bun * f_bun = sum_i p_i f_i, the EF identity)
#   prob:    p_bun = sum_i p_i
#
# PH over bundles is then the same machinery with S/k "scenarios".
# Two-stage only, like the reference (ref:proper_bundler.py:22).  The
# arrays equal the JAX package's exactly (the same float64 numpy code).
###############################################################################
from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.utils import pickle_bundle
from mpisppy_tpu_torch.utils.sputils import extract_num


def form_bundle_spec(members: list[ScenarioSpec],
                     name: str) -> ScenarioSpec:
    """EF of the member scenarios with shared nonant columns."""
    first = members[0]
    nonant_idx = np.asarray(first.nonant_idx, np.int64)
    N = len(nonant_idx)
    n = first.c.shape[0]
    oth = np.setdiff1d(np.arange(n), nonant_idx)
    n_oth = len(oth)
    k = len(members)

    nones = [m.probability is None for m in members]
    if any(nones) and not all(nones):
        raise ValueError(
            "form_bundle_spec: members mix explicit and None (uniform) "
            "probabilities; make them consistent before bundling")
    p_i = np.ones(k) if all(nones) else \
        np.array([m.probability for m in members])
    p_bun = p_i.sum()
    w = p_i / p_bun

    n_new = N + k * n_oth
    # column map per member: full column j -> bundle column
    colmap = np.empty((k, n), np.int64)
    for i in range(k):
        colmap[i, nonant_idx] = np.arange(N)
        colmap[i, oth] = N + i * n_oth + np.arange(n_oth)

    c = np.zeros(n_new)
    q = np.zeros(n_new)
    l = np.empty(n_new)  # noqa: E741
    u = np.empty(n_new)
    integer = np.zeros(n_new, bool)
    l[:N] = -np.inf
    u[:N] = np.inf
    rows_l, rows_u, blocks = [], [], []
    for i, m in enumerate(members):
        cm = colmap[i]
        c[cm] += w[i] * np.asarray(m.c, np.float64)
        if m.q is not None:
            q[cm] += w[i] * np.asarray(m.q, np.float64)
        # nonant box: intersection across members; others: per member
        l[:N] = np.maximum(l[:N], np.asarray(m.l)[nonant_idx]) \
            if i else np.asarray(m.l)[nonant_idx]
        u[:N] = np.minimum(u[:N], np.asarray(m.u)[nonant_idx]) \
            if i else np.asarray(m.u)[nonant_idx]
        l[N + i * n_oth:N + (i + 1) * n_oth] = np.asarray(m.l)[oth]
        u[N + i * n_oth:N + (i + 1) * n_oth] = np.asarray(m.u)[oth]
        if m.integer is not None:
            integer[cm] |= np.asarray(m.integer, bool)
        A = m.A if sps.issparse(m.A) else sps.csr_matrix(np.asarray(m.A))
        A = A.tocoo()
        blocks.append(sps.coo_matrix(
            (A.data, (A.row, cm[A.col])), shape=(A.shape[0], n_new)))
        rows_l.append(np.asarray(m.bl, np.float64))
        rows_u.append(np.asarray(m.bu, np.float64))

    A_bun = sps.vstack(blocks).tocsr()
    return ScenarioSpec(
        name=name, c=c, A=A_bun,
        bl=np.concatenate(rows_l), bu=np.concatenate(rows_u),
        l=l, u=u, nonant_idx=np.arange(N, dtype=np.int32),
        q=q if q.any() else None,
        probability=None if all(m.probability is None for m in members)
        else float(p_bun),
        integer=integer if integer.any() else None,
    )


class ProperBundler:
    """Module wrapper with the reference's API shape
    (ref:proper_bundler.py:29-120): bundle names Bundle_<lo>_<hi>,
    scenario_creator dispatching on the name, optional pickle dirs."""

    def __init__(self, module):
        self.module = module

    def inparser_adder(self, cfg):
        self.module.inparser_adder(cfg)

    def scenario_names_creator(self, num_scens, start=None):
        return self.module.scenario_names_creator(num_scens, start=start)

    def bundle_names_creator(self, num_buns, start=None, cfg=None):
        assert cfg is not None, "ProperBundler needs cfg for bundle names"
        if cfg.get("num_scens") is None \
                or cfg.get("scenarios_per_bundle") is None:
            raise ValueError("ProperBundler needs num_scens and "
                             "scenarios_per_bundle in the config")
        bsize = int(cfg["scenarios_per_bundle"])
        num_scens = int(cfg["num_scens"])
        assert num_scens % bsize == 0, \
            "num_scens must be a multiple of scenarios_per_bundle"
        start = 0 if start is None else start
        inum = extract_num(self.module.scenario_names_creator(1)[0])
        return [f"Bundle_{bn * bsize + inum}_{(bn + 1) * bsize - 1 + inum}"
                for bn in range(start, start + num_buns)]

    def kw_creator(self, cfg):
        kw = self.module.kw_creator(cfg)
        self.original_kwargs = dict(kw)
        kw["cfg"] = cfg
        return kw

    def scenario_creator(self, sname, cfg=None, **kwargs):
        if "Bundle" not in sname:
            return self.module.scenario_creator(
                sname, **{**getattr(self, "original_kwargs", {}),
                          **kwargs})
        if cfg is not None and cfg.get("unpickle_bundles_dir"):
            return pickle_bundle.read_spec(cfg["unpickle_bundles_dir"],
                                           sname)
        lo = int(sname.split("_")[1])
        hi = int(sname.split("_")[2])
        snames = self.module.scenario_names_creator(hi - lo + 1, lo)
        kw = getattr(self, "original_kwargs", kwargs)
        members = [self.module.scenario_creator(nm, **kw)
                   for nm in snames]
        bundle = form_bundle_spec(members, sname)
        if cfg is not None and cfg.get("pickle_bundles_dir"):
            pickle_bundle.write_spec(bundle, cfg["pickle_bundles_dir"])
        return bundle

    def scenario_denouement(self, rank, sname, spec, x=None):
        if hasattr(self.module, "scenario_denouement"):
            self.module.scenario_denouement(rank, sname, spec, x)
