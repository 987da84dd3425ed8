###############################################################################
# Sampled subtrees for multistage evaluation (port of
# mpisppy_tpu/confidence_intervals/sample_tree.py;
# ref:mpisppy/confidence_intervals/sample_tree.py:23-318).
#
# SampleSubtree builds a sampled multistage batch (the module must expose
# make_tree(branching_factors) and a seedable scenario_creator, e.g.
# models.aircond's start_seed) and solves its EF (algos/ef.py, one
# problem), optionally with the root stage pinned at a given x̂.
#
# walking_tree_xhats (ref:sample_tree.py:191-260): a feasible,
# nonanticipative policy for EVERY non-leaf node.  The reference
# resolves one subtree per node recursively; here ONE EF solve of the
# sampled tree with the root fixed already gives nonanticipative
# per-node values: the per-node averages of the EF solution (exact
# consensus by the EF's nonant rows) are the node x̂s.
###############################################################################
from __future__ import annotations

import inspect
import math

import numpy as np

from mpisppy_tpu_torch.confidence_intervals.ciutils import (
    DEFAULT_OPTS, ci_device,
)
from mpisppy_tpu_torch.ops import pdhg


class SampleSubtree:
    """ref:sample_tree.py:23.  Runs on `device` (default: the cfg's
    "device", else CUDA)."""

    def __init__(self, module, xhats, branching_factors, seed: int,
                 cfg, opts: pdhg.PDHGOptions | None = None, device=None):
        self.module = module
        self.xhats = None if xhats is None or len(xhats) == 0 \
            else np.asarray(xhats, np.float64)
        self.branching_factors = tuple(int(b) for b in branching_factors)
        self.seed = seed
        self.cfg = cfg
        self.opts = opts or DEFAULT_OPTS
        self.device = ci_device(cfg, device)
        self.EF_obj = None
        self.ef = None
        self.seed_provenance = None

    def _scengen_program(self, num: int):
        """The sampled tree's ScenarioProgram when the module ships one
        and the cfg opts in; None draws from the node-seeded host path
        (scengen.program_from_cfg owns the gate and the audible
        fallback).  The tree's branching factors and base seed come from
        THIS subtree, not the cfg."""
        from mpisppy_tpu_torch.scengen.program import program_from_cfg
        return program_from_cfg(
            self.module, self.cfg, num, seed=self.seed,
            drop=("start_seed", "branching_factors"),
            branching_factors=self.branching_factors)

    def run(self):
        from mpisppy_tpu_torch.algos.ef import ExtensiveForm
        kw = dict(self.module.kw_creator(self.cfg))
        kw["branching_factors"] = self.branching_factors
        if _accepts_start_seed(self.module):
            kw["start_seed"] = self.seed
        num = math.prod(self.branching_factors)
        names = self.module.scenario_names_creator(num)
        tree = self.module.make_tree(self.branching_factors)
        creator = self.module.scenario_creator
        prog = self._scengen_program(num)
        if prog is not None:
            # node draws fold the tree-node id into PRNGKey(self.seed)
            # instead of seeding a RandomState per node: the same
            # node-sharing structure, draws independent of the layout,
            # and a provenance record
            from mpisppy_tpu_torch.utils.sputils import extract_num
            self.seed_provenance = prog.provenance()

            def creator(name, **_kw):
                return prog.spec_at(extract_num(name))
        self.ef = ExtensiveForm({"tol": self.opts.tol,
                                 "max_iters": self.opts.max_iters},
                                names, creator, kw, tree=tree,
                                device=self.device)
        if self.xhats is not None:
            # pin the root stage's slots at the given x̂
            self.ef.fix_root_nonants(self.xhats)
        st = self.ef.solve_extensive_form()
        self.EF_obj = self.ef.get_objective_value()
        self._state = st
        return self.EF_obj


def _accepts_start_seed(module) -> bool:
    """True if scenario_creator can receive start_seed, as an explicit
    named parameter or through a **kw catch-all (aircond takes it via
    **kw; dropping it there would make every sampled subtree identical,
    ref:sample_tree.py:137-138)."""
    params = inspect.signature(module.scenario_creator).parameters
    if "start_seed" in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def walking_tree_xhats(module, xhat_one, branching_factors, seed, cfg,
                       opts: pdhg.PDHGOptions | None = None, device=None):
    """Per-node x̂s for a sampled tree with the root pinned at xhat_one
    (ref:sample_tree.py:191-260).  Returns (xhats (num_nodes, N),
    next_seed)."""
    st = SampleSubtree(module, xhat_one, branching_factors, seed, cfg,
                       opts, device=device)
    st.run()
    batch_tree = st.ef.ef.tree
    sol = st.ef.x                             # (S, n) original space
    nonant_idx = np.asarray(st.ef.ef.nonant_idx)
    x_non = sol[:, nonant_idx]
    # pin the root block to xhat_one, average the rest per node
    node_of_slot = np.asarray(batch_tree.node_of_slot())
    N = x_non.shape[1]
    num_nodes = batch_tree.num_nodes
    xhats = np.zeros((num_nodes, N))
    counts = np.zeros((num_nodes, N))
    cols = np.broadcast_to(np.arange(N), node_of_slot.shape)
    np.add.at(xhats, (node_of_slot, cols), x_non)
    np.add.at(counts, (node_of_slot, cols), 1.0)
    xhats = np.divide(xhats, np.maximum(counts, 1.0))
    n_root = int(np.asarray(xhat_one).shape[-1])
    xhats[0, :n_root] = np.asarray(xhat_one)
    next_seed = seed + _number_of_nodes(branching_factors)
    return xhats, next_seed


def _number_of_nodes(branching_factors) -> int:
    """TOTAL node-id count consumed by node-seeded samplers (aircond
    keys its RandomState by node_idx over ALL stages including the
    leaves, ref:aircond.py:44-75): advancing by less would overlap the
    seed streams of consecutive sampled trees and correlate the
    'independent' samples."""
    total, acc = 1, 1
    for b in branching_factors:
        acc *= b
        total += acc
    return total
