###############################################################################
# Rolling-horizon (MPC) windows (port of mpisppy_tpu/mpc).  Receding-
# horizon control re-solves a nearly identical stochastic program every
# step with shifted data, warm-started from the previous step's shifted
# PH plane:
#
#   horizon.py  declarative HorizonSpec (window, stride, per-step data
#               shift) and the uc and ccopf --soc horizons
#   shift.py    the warm-start shift rolling W/x̄/x forward by the stride
#   driver.py   RollingDriver: the shifted wheel to a per-step gap
#               target, the cold fallback, the typed StepDegraded
#   stream.py   the serve-layer integration: one long-lived latency
#               session streaming one solution line per step
###############################################################################
from mpisppy_tpu_torch.mpc.driver import (
    RollingDriver,
    StepDegraded,
    StepResult,
)
from mpisppy_tpu_torch.mpc.horizon import (
    HorizonSpec,
    ccopf_horizon,
    horizon_for,
    uc_horizon,
)
from mpisppy_tpu_torch.mpc.shift import (
    ShiftPlan,
    shift_state,
    shift_warm_plane,
)

__all__ = [
    "HorizonSpec", "RollingDriver", "ShiftPlan", "StepDegraded",
    "StepResult", "ccopf_horizon", "horizon_for", "shift_state",
    "shift_warm_plane", "uc_horizon",
]
