###############################################################################
# stoch_admmWrapper: scenario x region consensus ADMM as multistage PH
# (port of mpisppy_tpu/utils/stoch_admmWrapper.py; ref:mpisppy/utils/stoch_admmWrapper.py:36-237).
#
# Each (stochastic scenario s, admm region r) pair becomes one
# "scenario" of a 3-stage tree ROOT -> scenario nodes -> region leaves
# (ref:stoch_admmWrapper.py:104-116 create_node_names):
#   * stage-1 slots: the ORIGINAL first-stage variables — shared across
#     everything, reduced at ROOT;
#   * stage-2 slots: the consensus variables — shared across the
#     regions of ONE scenario, reduced at that scenario's node with
#     variable probabilities p_s / count(v)
#     (ref:stoch_admmWrapper.py:118-180 assign_variable_probs).
# Pair probability is p_s / R and each pair objective carries the
# region count R, so the PH expectation reproduces
# sum_s p_s sum_r f_{s,r} exactly.
#
# The user's scenario_creator(stoch_name, region_name, **kw) returns
# (ScenarioSpec, var_names) with spec.nonant_idx marking the ORIGINAL
# first-stage columns.  Originally-multistage problems (the reference's
# BFs path) are not supported here.
###############################################################################
from __future__ import annotations

import numpy as np


from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.core.tree import ScenarioTree
from mpisppy_tpu_torch.utils.admmWrapper import _consensus_vars_number_creator


class Stoch_AdmmWrapper:
    """ref:mpisppy/utils/stoch_admmWrapper.py:36."""

    def __init__(self, options, admm_subproblem_names,
                 stoch_scenario_names, scenario_creator, consensus_vars,
                 stoch_probabilities=None,
                 scenario_creator_kwargs=None, BFs=None, verbose=False):
        assert len(options) == 0, \
            "no options supported by stoch_admmWrapper"
        if BFs is not None:
            raise NotImplementedError(
                "originally-multistage problems (BFs) are not supported")
        self.admm_subproblem_names = list(admm_subproblem_names)
        self.stoch_scenario_names = list(stoch_scenario_names)
        R = len(self.admm_subproblem_names)
        Sst = len(self.stoch_scenario_names)
        self.number_admm_subproblems = R
        self.consensus_vars = consensus_vars
        self.consensus_vars_number = _consensus_vars_number_creator(
            consensus_vars)
        p_s = np.full(Sst, 1.0 / Sst) if stoch_probabilities is None \
            else np.asarray(stoch_probabilities, np.float64)
        kw = scenario_creator_kwargs or {}

        labels = sorted(self.consensus_vars_number)
        K = len(labels)

        # probe one pair per region for layout
        raw = {}
        for snm in self.stoch_scenario_names:
            for rnm in self.admm_subproblem_names:
                spec, var_names = scenario_creator(snm, rnm, **kw)
                missing = [v for v in consensus_vars[rnm]
                           if v not in var_names]
                if missing:
                    raise RuntimeError(
                        f"for ({snm}, {rnm}), consensus vars not in "
                        f"the model: {missing} "
                        "(ref:stoch_admmWrapper.py assign_variable_"
                        "probs error lists)")
                raw[snm, rnm] = (spec, list(var_names))

        n1 = len(raw[self.stoch_scenario_names[0],
                     self.admm_subproblem_names[0]][0].nonant_idx)
        n_loc = {}
        for (snm, rnm), (spec, vn) in raw.items():
            n_loc[snm, rnm] = (len(vn) - n1
                               - len(consensus_vars[rnm]))
        n_local_max = max(n_loc.values())
        m_max = max(sp.A.shape[0] for sp, _ in raw.values())
        n_new = n1 + K + n_local_max
        scale = float(R)

        from mpisppy_tpu_torch.utils.sputils import remap_spec_arrays
        label_ix = {v: i for i, v in enumerate(labels)}
        self.local_admm_stoch_subproblem_scenarios = {}
        self.all_pair_names = []
        for si, snm in enumerate(self.stoch_scenario_names):
            for rnm in self.admm_subproblem_names:
                spec, var_names = raw[snm, rnm]
                first_slot = {int(j): k for k, j in
                              enumerate(np.asarray(spec.nonant_idx))}
                mine = set(consensus_vars[rnm])
                colmap = np.empty(len(var_names), np.int64)
                loc = 0
                for j, v in enumerate(var_names):
                    if j in first_slot:
                        colmap[j] = first_slot[j]
                    elif v in mine:
                        colmap[j] = n1 + label_ix[v]
                    else:
                        colmap[j] = n1 + K + loc
                        loc += 1

                parts = remap_spec_arrays(spec, colmap, n_new, m_max,
                                          scale=scale)

                # nonant slots: stage-1 block then consensus block
                var_prob = np.zeros(n1 + K)
                var_prob[:n1] = p_s[si] / R
                for v in mine:
                    var_prob[n1 + label_ix[v]] = \
                        p_s[si] / self.consensus_vars_number[v]

                pname = f"ADMM_STOCH_{snm}_{rnm}"
                self.all_pair_names.append(pname)
                self.local_admm_stoch_subproblem_scenarios[pname] = \
                    ScenarioSpec(
                        name=pname,
                        nonant_idx=np.arange(n1 + K, dtype=np.int32),
                        probability=float(p_s[si] / R),
                        var_prob=var_prob, **parts)
        self._n1, self._K = n1, K

    def split_admm_stoch_subproblem_scenario_name(self, pname: str):
        """ref:stoch_admmWrapper.py split function (inverse of the pair
        naming)."""
        body = pname[len("ADMM_STOCH_"):]
        for rnm in self.admm_subproblem_names:
            if body.endswith("_" + rnm):
                return body[:-(len(rnm) + 1)], rnm
        raise ValueError(f"cannot split pair name {pname!r}")

    def admmWrapper_scenario_creator(self, pname: str) -> ScenarioSpec:
        return self.local_admm_stoch_subproblem_scenarios[pname]

    def make_tree(self) -> ScenarioTree:
        return ScenarioTree(
            branching_factors=(len(self.stoch_scenario_names),
                               self.number_admm_subproblems),
            nonants_per_stage=(self._n1, self._K))

    def make_batch(self, device=None):
        """The wrapped problem as one ScenarioBatch, on CUDA unless
        device="cpu" is given (core.batch.from_specs)."""
        from mpisppy_tpu_torch.core import batch as batch_mod
        specs = [self.local_admm_stoch_subproblem_scenarios[nm]
                 for nm in self.all_pair_names]
        return batch_mod.from_specs(specs, tree=self.make_tree(),
                                    device=device)
