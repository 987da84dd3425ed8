###############################################################################
# admmWrapper: consensus ADMM as a PH problem (port of
# mpisppy_tpu/utils/admmWrapper.py; ref:mpisppy/utils/admmWrapper.py:37-167).
#
# A generic consensus problem  min sum_r f_r(x_r, y_r)
#                              s.t. x_r[v] equal across the regions r
#                                   that share consensus variable v
# becomes "stochastic": each admm subproblem (region) is a SCENARIO,
# the consensus variables are the nonants, and nonanticipativity is
# enforced with VARIABLE probabilities 1/(#regions sharing v)
# (ref:admmWrapper.py:111-120) — a var absent from a region is added as
# a dummy fixed-at-0 column with weight 0 (ref:admmWrapper.py:129-141).
# Objectives are multiplied by the region count so the uniform-p PH
# expectation reproduces the plain sum (ref:admmWrapper.py:157-166).
#
# One batch: regions may have heterogeneous column/row counts; the wrapper re-lays every region spec out as
#   [consensus block (K, shared order)] ++ [padded local columns]
# and pads rows, so the whole consensus problem is ONE ScenarioBatch.
#
# The user's scenario_creator returns a ScenarioSpec plus `var_names`
# (the label of every column) — the analog of Pyomo component names the
# reference resolves with find_component.
###############################################################################
from __future__ import annotations


import numpy as np


from mpisppy_tpu_torch.core.batch import ScenarioSpec


def _consensus_vars_number_creator(consensus_vars: dict) -> dict:
    """label -> number of subproblems sharing it
    (ref:admmWrapper.py:24-34)."""
    count: dict = {}
    for sub, labels in consensus_vars.items():
        for v in labels:
            count[v] = count.get(v, 0) + 1
    return count


class AdmmWrapper:
    """ref:mpisppy/utils/admmWrapper.py:37.

    Args:
        all_scenario_names: admm subproblem names.
        scenario_creator(name, **kwargs) -> (ScenarioSpec, var_names).
        consensus_vars: {subproblem_name: [labels]}.
    """

    def __init__(self, options, all_scenario_names, scenario_creator,
                 consensus_vars, n_cylinders: int = 1, mpicomm=None,
                 scenario_creator_kwargs=None, verbose=False):
        assert len(options) == 0, "no options supported by AdmmWrapper"
        self.all_scenario_names = list(all_scenario_names)
        self.consensus_vars = consensus_vars
        self.consensus_vars_number = _consensus_vars_number_creator(
            consensus_vars)
        self.number_of_scenario = len(self.all_scenario_names)
        kw = scenario_creator_kwargs or {}

        labels = sorted(self.consensus_vars_number)
        self._labels = labels
        K = len(labels)
        raw = {}
        for nm in self.all_scenario_names:
            spec, var_names = scenario_creator(nm, **kw)
            missing = [v for v in consensus_vars[nm]
                       if v not in var_names]
            if missing:
                raise RuntimeError(
                    f"for {nm}, consensus vars not in the model: "
                    f"{missing} (ref:admmWrapper.py:143-147)")
            raw[nm] = (spec, list(var_names))

        n_loc = {nm: len(vn) - len(consensus_vars[nm])
                 for nm, (sp, vn) in raw.items()}
        n_local_max = max(n_loc.values())
        m_max = max(sp.A.shape[0] for sp, _ in raw.values())
        n_new = K + n_local_max

        from mpisppy_tpu_torch.utils.sputils import remap_spec_arrays
        label_ix = {v: i for i, v in enumerate(labels)}
        self.local_scenarios = {}
        self.varprob_dict = {}
        for nm, (spec, var_names) in raw.items():
            mine = set(consensus_vars[nm])
            colmap = np.empty(len(var_names), np.int64)
            loc = 0
            for j, v in enumerate(var_names):
                if v in mine:
                    colmap[j] = label_ix[v]
                else:
                    colmap[j] = K + loc
                    loc += 1

            # the objective carries the region-count factor so uniform-p
            # PH expectation = the plain admm sum; absent consensus +
            # unused local pad columns come back fixed at 0
            parts = remap_spec_arrays(spec, colmap, n_new, m_max,
                                      scale=self.number_of_scenario)

            var_prob = np.zeros(K)
            for v in mine:
                var_prob[label_ix[v]] = \
                    1.0 / self.consensus_vars_number[v]
            self.varprob_dict[nm] = var_prob

            self.local_scenarios[nm] = ScenarioSpec(
                name=nm, nonant_idx=np.arange(K, dtype=np.int32),
                var_prob=var_prob, **parts)

    def var_prob_list(self, sname: str):
        """(slot, weight) pairs (ref:admmWrapper.py:97-103)."""
        return list(enumerate(self.varprob_dict[sname]))

    def admmWrapper_scenario_creator(self, sname: str) -> ScenarioSpec:
        """The scenario_creator handed to PH/cylinders
        (ref:admmWrapper.py:157-166)."""
        return self.local_scenarios[sname]

    def make_batch(self, device=None):
        """The wrapped problem as one ScenarioBatch, on CUDA unless
        device="cpu" is given (core.batch.from_specs)."""
        from mpisppy_tpu_torch.core import batch as batch_mod
        specs = [self.local_scenarios[nm]
                 for nm in self.all_scenario_names]
        return batch_mod.from_specs(specs, device=device)
