###############################################################################
# Config groups for CI runs (port of
# mpisppy_tpu/confidence_intervals/confidence_config.py;
# ref:mpisppy/confidence_intervals/confidence_config.py:42-93).
###############################################################################
from __future__ import annotations


def confidence_config(cfg):
    cfg.add_to_config("confidence_level", "CI confidence level", float,
                      0.95)
    cfg.add_to_config("xhatpath", "path of an xhat .npy file", str, None)
    # scengen replications: when the model module ships a
    # ScenarioProgram, draw every estimator and replication sample
    # through counter-based scengen keys instead of per-scenario host
    # numpy streams (unlimited replications, draws independent of the
    # layout, and a seed_provenance record in the outputs).  The library
    # default is the host stream (cfg.get(..., False)); CI-configured
    # runs get scengen by default through this declaration.
    cfg.add_to_config("use_scengen",
                      "draw CI replications through scengen "
                      "counter-based keys when the model has a "
                      "ScenarioProgram", bool, True)
    cfg.add_to_config("scengen_seed",
                      "base seed of the scengen replication key "
                      "stream", int, 0)


def sequential_config(cfg):
    cfg.add_to_config("sample_size_ratio",
                      "xhat sample size / estimator sample size", float,
                      1.0)
    cfg.add_to_config("ArRP", "pooled estimator count", int, 1)
    cfg.add_to_config("kf_Gs", "resampling frequency for G and s", int, 1)
    cfg.add_to_config("kf_xhat", "resampling frequency for xhat", int, 1)
    # programmatic-only knobs (no CLI flag): seqsampling reads these
    # off the cfg when a driver quick_assigns them
    # (ref:seqsampling.py options plumbing)
    cfg.add_to_config("growth_function",
                      "BPL sample-growth callable g(k) (programmatic; "
                      "default linear k-1)", object, None,
                      argparse=False)
    cfg.add_to_config("xhat_gen_kwargs",
                      "extra kwargs for the xhat generator "
                      "(programmatic)", dict, None, argparse=False)


def BM_config(cfg):
    """ref:confidence_config.py:42-75."""
    cfg.add_to_config("BM_h", "BM h parameter", float, 1.75)
    cfg.add_to_config("BM_hprime", "BM h' parameter", float, 0.5)
    cfg.add_to_config("BM_eps", "BM epsilon", float, 0.2)
    cfg.add_to_config("BM_eps_prime", "BM epsilon'", float, 0.1)
    cfg.add_to_config("BM_p", "BM p parameter", float, 0.191)
    cfg.add_to_config("BM_q", "BM q parameter", float, 1.2)


def BPL_config(cfg):
    """ref:confidence_config.py:76-93."""
    cfg.add_to_config("BPL_eps", "BPL epsilon", float, 0.5)
    cfg.add_to_config("BPL_c0", "BPL c0 sample-size constant", int, 50)
    cfg.add_to_config("BPL_c1", "BPL c1 growth constant", int, 10)
    cfg.add_to_config("BPL_n0min", "BPL stochastic n0 minimum", int, 50)
