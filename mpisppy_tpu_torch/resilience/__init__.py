# Resilience of the port (port of mpisppy_tpu/resilience): the fault
# plan's seams (faults.py) and the hub progress watchdog (watchdog.py).
from mpisppy_tpu_torch.resilience.faults import (  # noqa: F401
    AsyncExchangeFault, CheckpointFault, DispatchFault, DispatchPoison,
    FaultPlan, LaneFault, MeshFault, PreemptionError, ReplicaFault,
    ServeFault, SimulatedPreemption, SpokeBoundFault,
)
from mpisppy_tpu_torch.resilience.watchdog import HubWatchdog  # noqa: F401
