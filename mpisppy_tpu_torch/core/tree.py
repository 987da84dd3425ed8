###############################################################################
# Scenario trees (port of mpisppy_tpu/core/tree.py; numpy only).
#
# The reference represents a scenario tree as per-scenario lists of
# ScenarioNode objects hanging off Pyomo models, parsed into a _ScenTree
# with per-node MPI communicators (ref:mpisppy/scenario_tree.py:51,
# ref:mpisppy/utils/sputils.py:691-856, ref:mpisppy/spbase.py:337-379).
# Here the tree is *static metadata* (hashable, frozen)
# plus two small index arrays:
#
#   * every scenario carries one nonant value per "slot"; a slot is one
#     (stage, variable) pair, so the nonant vector has the same length N
#     for every scenario;
#   * `node_of_slot[s, i]` maps scenario s's slot i to the global id of
#     the tree node that owns it.  Nonanticipativity is then a *segmented
#     reduction*: slots sharing a (node, slot) key are averaged — the
#     analog of the reference's one-Allreduce-per-node-comm
#     (ref:mpisppy/phbase.py:88-92) without any communicator objects.
#
# Trees are balanced with per-stage branching factors, matching the
# reference's ROOT/ROOT_0/ROOT_0_1 naming scheme
# (ref:mpisppy/utils/sputils.py:992-1034).  A two-stage problem is the
# special case branching_factors=(S,) with the single node ROOT.
###############################################################################
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScenarioTree:
    """Balanced scenario tree metadata.

    branching_factors: (b1, ..., b_{T-1}); num scenarios = prod(b).
    nonants_per_stage: number of nonant variables declared at each
        non-leaf stage (length T-1).  Two-stage: (N,).
    """

    branching_factors: tuple[int, ...]
    nonants_per_stage: tuple[int, ...]

    def __post_init__(self):
        if len(self.branching_factors) != len(self.nonants_per_stage):
            raise ValueError("branching_factors and nonants_per_stage must "
                             "have one entry per non-leaf stage")

    @property
    def num_stages(self) -> int:
        return len(self.branching_factors) + 1

    @property
    def num_scenarios(self) -> int:
        return math.prod(self.branching_factors)

    @property
    def num_nonant_slots(self) -> int:
        return sum(self.nonants_per_stage)

    @property
    def nodes_per_stage(self) -> tuple[int, ...]:
        """Non-leaf node count at stage t = prod(b[:t-1]); stage 1 -> 1."""
        out, acc = [], 1
        for b in self.branching_factors:
            out.append(acc)
            acc *= b
        return tuple(out)

    @property
    def num_nodes(self) -> int:
        return sum(self.nodes_per_stage)

    @property
    def stage_node_offset(self) -> tuple[int, ...]:
        """Global node-id offset of each non-leaf stage's first node."""
        offs, acc = [], 0
        for c in self.nodes_per_stage:
            offs.append(acc)
            acc += c
        return tuple(offs)

    @property
    def slot_stage(self) -> np.ndarray:
        """(N,) stage index (1-based) of each nonant slot."""
        return np.concatenate([
            np.full(n, t + 1, np.int32)
            for t, n in enumerate(self.nonants_per_stage)
        ]) if self.num_nonant_slots else np.zeros(0, np.int32)

    def scen_node_at_stage(self, scen: np.ndarray, stage: int) -> np.ndarray:
        """Global node id of `scen` (0-based) at non-leaf `stage` (1-based).

        Scenarios are numbered depth-first, so the stage-t node of
        scenario s is s // (scenarios per stage-t node) — the same
        contiguous-slice layout as the reference's _ScenTree
        (ref:mpisppy/utils/sputils.py:790-856).
        """
        per_node = math.prod(self.branching_factors[stage - 1:])
        return self.stage_node_offset[stage - 1] + scen // per_node

    def node_of_slot(self) -> np.ndarray:
        """(S, N) global node id owning each scenario's nonant slot."""
        s = np.arange(self.num_scenarios)
        cols = []
        for t, n in enumerate(self.nonants_per_stage):
            node = self.scen_node_at_stage(s, t + 1)
            cols.append(np.repeat(node[:, None], n, axis=1))
        if not cols:
            return np.zeros((self.num_scenarios, 0), np.int32)
        return np.concatenate(cols, axis=1).astype(np.int32)

    def node_name(self, node_id: int) -> str:
        """ROOT / ROOT_i / ROOT_i_j naming (ref:mpisppy/utils/sputils.py:992)."""
        offs = self.stage_node_offset
        stage = max(t for t, o in enumerate(offs) if o <= node_id) + 1
        rel = node_id - offs[stage - 1]
        parts = []
        for t in range(stage - 1, 0, -1):
            b = self.branching_factors[t - 1]
            parts.append(rel % b)
            rel //= b
        return "_".join(["ROOT"] + [str(p) for p in reversed(parts)])

    def all_nodenames(self) -> list[str]:
        return [self.node_name(i) for i in range(self.num_nodes)]


def two_stage_tree(num_scenarios: int, num_nonants: int) -> ScenarioTree:
    """The common case: one ROOT node owning all first-stage variables."""
    return ScenarioTree(branching_factors=(num_scenarios,),
                        nonants_per_stage=(num_nonants,))
