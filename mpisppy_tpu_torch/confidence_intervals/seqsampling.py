###############################################################################
# Sequential sampling to a target optimality-gap CI (port of
# mpisppy_tpu/confidence_intervals/seqsampling.py;
# ref:mpisppy/confidence_intervals/seqsampling.py:114-520).
#
# Bayraksan-Morton (BM, fixed-width) and Bayraksan-Pierre-Louis (BPL,
# fully sequential / stochastic) procedures: grow the sample until the
# gap estimate at the current candidate x̂ clears the stopping rule,
# with the reference's exact sample-size recursions
# (ref:seqsampling.py:269-333).  Every sampled EF and evaluation runs on
# `device` (default: the cfg's "device", else CUDA).
###############################################################################
from __future__ import annotations

import math

import numpy as np
import scipy.stats

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.confidence_intervals import ciutils


class SeqSampling:
    """ref:seqsampling.py:114.  `module` is a model module;
    `xhat_generator(scenario_names, **kw) -> root xhat array`.  The gap
    estimators solve every sampled EF and evaluation at
    ciutils.DEFAULT_OPTS."""

    def __init__(self, module, xhat_generator, cfg,
                 stochastic_sampling: bool = False,
                 stopping_criterion: str = "BM",
                 solving_type: str = "EF_2stage", device=None):
        if solving_type != "EF_2stage":
            raise RuntimeError("only EF_2stage sequential sampling is "
                               "supported (ref parity: EF only)")
        self.module = module
        self.xhat_generator = xhat_generator
        self.cfg = cfg
        self.device = ciutils.ci_device(cfg, device)
        self.stochastic_sampling = stochastic_sampling
        self.stopping_criterion = stopping_criterion
        self.sample_size_ratio = cfg.get("sample_size_ratio", 1)
        self.xhat_gen_kwargs = cfg.get("xhat_gen_kwargs", {}) or {}
        self.confidence_level = cfg.get("confidence_level", 0.95)
        self.ArRP = cfg.get("ArRP", 1)
        self.kf_Gs = cfg.get("kf_Gs", 1)
        self.kf_xhat = cfg.get("kf_xhat", 1)
        # BM parameters (ref:seqsampling.py defaults)
        self.BM_h = cfg.get("BM_h", 1.75)
        self.BM_hprime = cfg.get("BM_hprime", 0.5)
        self.BM_eps = cfg.get("BM_eps", 0.2)
        self.BM_eps_prime = cfg.get("BM_eps_prime", 0.1)
        self.BM_p = cfg.get("BM_p", 0.191)
        self.BM_q = cfg.get("BM_q", 1.2)
        # BPL parameters
        self.BPL_eps = cfg.get("BPL_eps", 0.5)
        self.BPL_c0 = cfg.get("BPL_c0", 50)
        self.BPL_c1 = cfg.get("BPL_c1", 10)
        self.BPL_n0min = cfg.get("BPL_n0min", 50)
        # default growth_function is linear in k (ref:seqsampling.py
        # growth_function default = (k-1))
        self.growth_function = cfg.get("growth_function", None) \
            or (lambda k: k - 1)

        if stopping_criterion == "BM":
            self.stop_criterion = self.bm_stopping_criterion
        elif stopping_criterion == "BPL":
            self.stop_criterion = self.bpl_stopping_criterion
        else:
            raise RuntimeError("Only BM and BPL criteria are supported.")
        if self.stochastic_sampling:
            self.sample_size = self.stochastic_sampsize
        elif stopping_criterion == "BM":
            self.sample_size = self.bm_sampsize
        else:
            self.sample_size = self.bpl_fsp_sampsize
        self.ScenCount = 0

    # -- stopping rules (ref:seqsampling.py:269-278) ----------------------
    def bm_stopping_criterion(self, G, s, nk):
        return G > self.BM_hprime * s + self.BM_eps_prime

    def bpl_stopping_criterion(self, G, s, nk):
        t = scipy.stats.t.ppf(self.confidence_level, nk - 1)
        return G + t * s / math.sqrt(nk) + 1.0 / math.sqrt(nk) \
            > self.BPL_eps

    # -- sample sizes (ref:seqsampling.py:280-333) ------------------------
    def bm_sampsize(self, k, G, s, nk_m1, r=2):
        p, q = self.BM_p, self.BM_q
        h, hprime = self.BM_h, self.BM_hprime
        j = np.arange(1, 1000)
        if q is None:
            if not hasattr(self, "c"):
                ssum = float(np.sum(np.power(j.astype(float),
                                             -p * np.log(j))))
                self.c = max(1.0, 2 * math.log(
                    ssum / (math.sqrt(2 * math.pi)
                            * (1 - self.confidence_level))))
            lower = (self.c + 2 * p * math.log(k) ** 2) \
                / ((h - hprime) ** 2)
        else:
            if q < 1:
                raise RuntimeError("Parameter q should be greater "
                                   "than 1.")
            if not hasattr(self, "c"):
                ssum = float(np.sum(np.exp(-p * np.power(
                    j.astype(float), 2 * q / r))))
                self.c = max(1.0, 2 * math.log(
                    ssum / (math.sqrt(2 * math.pi)
                            * (1 - self.confidence_level))))
            lower = (self.c + 2 * p * k ** (2 * q / r)) \
                / ((h - hprime) ** 2)
        return int(math.ceil(lower))

    def bpl_fsp_sampsize(self, k, G, s, nk_m1):
        return int(math.ceil(self.BPL_c0
                             + self.BPL_c1 * self.growth_function(k)))

    def stochastic_sampsize(self, k, G, s, nk_m1):
        if k == 1:
            return int(math.ceil(max(self.BPL_n0min,
                                     math.log(1.0 / self.BPL_eps))))
        t = scipy.stats.t.ppf(self.confidence_level, nk_m1 - 1)
        a = -self.BPL_eps
        b = 1.0 + t * s
        c = nk_m1 * G
        disc = max(b * b - 4 * a * c, 0.0)
        maxroot = -(math.sqrt(disc) + b) / (2 * a)
        return int(math.ceil(maxroot ** 2))

    # -- the driver (ref:seqsampling.py:335-520) --------------------------
    def run(self, maxit: int = 200) -> dict:
        module = self.module
        mult = self.sample_size_ratio
        k = 1
        lower_bound_k = self.sample_size(k, None, None, None)

        mk = int(math.floor(mult * lower_bound_k))
        xhat_names = module.scenario_names_creator(mk,
                                                   start=self.ScenCount)
        self.ScenCount += mk
        xhat_k = self.xhat_generator(xhat_names, **self.xhat_gen_kwargs)

        nk = self.ArRP * int(math.ceil(lower_bound_k / self.ArRP))
        est_names = module.scenario_names_creator(nk,
                                                  start=self.ScenCount)
        self.ScenCount += nk
        est = ciutils.gap_estimators(xhat_k, module, est_names,
                                     self.cfg, ArRP=self.ArRP,
                                     device=self.device)
        Gk, sk = est["G"], est["s"]

        while self.stop_criterion(Gk, sk, nk) and k < maxit:
            k += 1
            nk_m1 = nk
            lower_bound_k = self.sample_size(k, Gk, sk, nk_m1)
            mk = int(math.floor(mult * lower_bound_k))
            # kf_xhat: resample the candidate only every kf_xhat
            # iterations; otherwise extend the previous sample
            # (ref:seqsampling.py:447-460 reuse branches)
            if k % self.kf_xhat == 0 or len(xhat_names) == 0:
                xhat_names = module.scenario_names_creator(
                    mk, start=self.ScenCount)
                self.ScenCount += mk
            elif mk > len(xhat_names):
                extra = mk - len(xhat_names)
                xhat_names = xhat_names + module.scenario_names_creator(
                    extra, start=self.ScenCount)
                self.ScenCount += extra
            xhat_k = self.xhat_generator(xhat_names,
                                         **self.xhat_gen_kwargs)
            nk = self.ArRP * int(math.ceil(lower_bound_k / self.ArRP))
            if k % self.kf_Gs == 0 or nk > nk_m1 * 2:
                est_names = module.scenario_names_creator(
                    nk, start=self.ScenCount)
                self.ScenCount += nk
            elif nk > len(est_names):
                extra = nk - len(est_names)
                est_names = est_names + module.scenario_names_creator(
                    extra, start=self.ScenCount)
                self.ScenCount += extra
            est = ciutils.gap_estimators(xhat_k, module, est_names,
                                         self.cfg, ArRP=self.ArRP,
                                         device=self.device)
            Gk, sk = est["G"], est["s"]
            global_toc(f"seq sampling iter {k}: n={nk} G={Gk:.5g} "
                       f"s={sk:.5g}", True)

        # The coverage guarantee only holds if the stopping rule was
        # actually met; at k == maxit the reference raises RuntimeError
        # (ref:seqsampling.py maxit guard).  We flag instead so callers
        # can still inspect the partial result, but loudly.
        converged = not self.stop_criterion(Gk, sk, nk)
        if not converged:
            global_toc(f"WARNING: sequential sampling hit maxit={maxit} "
                       "without satisfying the stopping criterion; the "
                       "returned CI has NO coverage guarantee", True)

        # CI on the gap at the final candidate (ref theory: width from
        # the stopping rule's parameters)
        if self.stopping_criterion == "BM":
            upper = self.BM_h * sk + self.BM_eps
        else:
            t = scipy.stats.t.ppf(self.confidence_level, nk - 1)
            upper = Gk + t * sk / math.sqrt(nk) + 1.0 / math.sqrt(nk)
        out = {"T": k, "Candidate_solution": xhat_k,
               "CI": [0.0, float(upper)], "G": Gk, "s": sk, "nk": nk,
               "converged": converged}
        if "seed_provenance" in est:
            # scengen draws: the final estimator's key window; with
            # ScenCount, the whole sample sequence is reproducible from
            # counter-based keys alone
            out["seed_provenance"] = est["seed_provenance"]
        return out


class IndepScens_SeqSampling(SeqSampling):
    """Multistage sequential sampling over independently sampled
    scenario TREES (ref:mpisppy/confidence_intervals/
    multi_seqsampling.py:31-340).  Each i.i.d. sample is one seeded
    subtree with the configured branching factors; the stopping rules
    and sample-size recursions are inherited unchanged (they only see
    (G, s, nk), with nk counting trees).

    `xhat_generator(mk, start_seed, **kw) -> root xhat`: candidate from
    mk sampled scenarios; defaults to the root solution of a free
    sampled-tree EF whose branching factors are scaled so the leaf
    count is close to mk (ciutils.scalable_branching_factors — the
    reference's xhat_generator_aircond analog)."""

    def __init__(self, module, xhat_generator, cfg,
                 stochastic_sampling: bool = False,
                 stopping_criterion: str = "BM",
                 solving_type: str = "EF_mstage", device=None):
        # bypass the parent's EF_2stage guard but reuse all its knobs
        super().__init__(module, xhat_generator, cfg,
                         stochastic_sampling=stochastic_sampling,
                         stopping_criterion=stopping_criterion,
                         solving_type="EF_2stage", device=device)
        self.solving_type = solving_type
        bfs = cfg.get("branching_factors")
        if not bfs:
            raise RuntimeError("IndepScens_SeqSampling needs "
                               "cfg['branching_factors']")
        self.branching_factors = [int(b) for b in bfs]
        self.numstages = len(self.branching_factors) + 1
        if self.xhat_generator is None:
            self.xhat_generator = self._default_xhat_gen

    def _candidate_seed_span(self, mk: int) -> int:
        """Seed ids a candidate generation consumes — advanced by run()
        for ANY generator, so a user-supplied xhat_generator can never
        leave ScenCount behind and have the gap estimator re-sample the
        very trees the candidate was fit to (which would bias G low and
        void the coverage guarantee)."""
        from mpisppy_tpu_torch.confidence_intervals.sample_tree import (
            _number_of_nodes,
        )
        bfs = ciutils.scalable_branching_factors(
            max(mk, 2), self.branching_factors)
        return _number_of_nodes(bfs)

    def _default_xhat_gen(self, mk: int, start_seed: int, **_kw):
        """Root xhat from a free sampled-tree EF with ~mk leaves.
        Consumes exactly _candidate_seed_span(mk) seed ids; custom
        generators must do the same (run() advances ScenCount by it)."""
        from mpisppy_tpu_torch.confidence_intervals.sample_tree import (
            SampleSubtree,
        )
        bfs = ciutils.scalable_branching_factors(
            max(mk, 2), self.branching_factors)
        st = SampleSubtree(self.module, None, bfs, start_seed, self.cfg,
                           device=self.device)
        st.run()
        sol = st.ef.x                               # (S, n) original
        nonant_idx = np.asarray(st.ef.ef.nonant_idx)
        tree = st.ef.ef.tree
        root_slots = np.nonzero(tree.slot_stage == 1)[0]
        x_non = sol[:, nonant_idx]
        xhat = x_non.mean(axis=0)[root_slots]
        return xhat

    def run(self, maxit: int = 200) -> dict:
        mult = self.sample_size_ratio
        bfs = self.branching_factors
        k = 1
        lower_bound_k = self.sample_size(k, None, None, None)

        mk = int(math.floor(mult * lower_bound_k))
        xhat_k = self.xhat_generator(mk, self.ScenCount,
                                     **self.xhat_gen_kwargs)
        self.ScenCount += self._candidate_seed_span(mk)

        nk = int(math.ceil(lower_bound_k))
        est = ciutils.gap_estimators_mstage(
            xhat_k, self.module, nk, self.cfg, self.ScenCount, bfs,
            device=self.device)
        self.ScenCount = est["seed"]
        Gk, sk = est["G"], est["s"]

        while self.stop_criterion(Gk, sk, nk) and k < maxit:
            k += 1
            nk_m1 = nk
            lower_bound_k = self.sample_size(k, Gk, sk, nk_m1)
            mk = int(math.floor(mult * lower_bound_k))
            if k % self.kf_xhat == 0:
                xhat_k = self.xhat_generator(mk, self.ScenCount,
                                             **self.xhat_gen_kwargs)
                self.ScenCount += self._candidate_seed_span(mk)
            nk = int(math.ceil(lower_bound_k))
            est = ciutils.gap_estimators_mstage(
                xhat_k, self.module, nk, self.cfg, self.ScenCount, bfs,
                device=self.device)
            self.ScenCount = est["seed"]
            Gk, sk = est["G"], est["s"]
            global_toc(f"multistage seq sampling iter {k}: trees={nk} "
                       f"G={Gk:.5g} s={sk:.5g}", True)

        converged = not self.stop_criterion(Gk, sk, nk)
        if not converged:
            global_toc(f"WARNING: sequential sampling hit maxit={maxit} "
                       "without satisfying the stopping criterion; the "
                       "returned CI has NO coverage guarantee", True)
        if self.stopping_criterion == "BM":
            upper = self.BM_h * sk + self.BM_eps
        else:
            t = scipy.stats.t.ppf(self.confidence_level, max(nk - 1, 1))
            upper = Gk + t * sk / math.sqrt(nk) + 1.0 / math.sqrt(nk)
        return {"T": k, "Candidate_solution": xhat_k,
                "CI": [0.0, float(upper)], "G": Gk, "s": sk, "nk": nk,
                "converged": converged}
