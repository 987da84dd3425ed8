###############################################################################
# Confidence intervals for a candidate solution x̂ (port of
# mpisppy_tpu/confidence_intervals): the Mak-Morton-Wood gap estimators
# (ciutils, mmw_ci, the mmw_conf CLI), Bayraksan-Morton and
# Bayraksan-Pierre-Louis sequential sampling (seqsampling), the
# objective distribution of a fixed x̂ (zhat4xhat) and sampled multistage
# trees (sample_tree).  Drivers above the wheel: every solve is the
# port's EF (algos/ef.py) or x̂ evaluation (algos/xhat.py).
###############################################################################
from mpisppy_tpu_torch.confidence_intervals import ciutils  # noqa: F401
