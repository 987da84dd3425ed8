###############################################################################
# The wheel fleet: N serve-layer replicas — each a full WheelServer
# with its own engine, device stream, structure interner, trace
# subdirectory and socket — behind ONE router that owns global
# admission (WFQ, quotas, SLA), structure-affine placement, replica
# health (heartbeats + status probes), and live session migration
# (emergency checkpoint on the source, restore-from-spool on the
# destination, the Session settle latch keeping terminal delivery
# exactly-once).  Port of mpisppy_tpu/fleet (docs/serving.md fleet
# section); every replica's wheels run on the router's device (CUDA
# unless FleetOptions(device="cpu")).
###############################################################################
from mpisppy_tpu_torch.fleet.health import DEAD, SUSPECT, UP, HealthBoard
from mpisppy_tpu_torch.fleet.migration import Migrator
from mpisppy_tpu_torch.fleet.placement import choose, routing_key
from mpisppy_tpu_torch.fleet.replica import Replica
from mpisppy_tpu_torch.fleet.router import FleetOptions, FleetRouter

__all__ = [
    "DEAD", "SUSPECT", "UP", "HealthBoard", "Migrator", "choose",
    "routing_key", "Replica", "FleetOptions", "FleetRouter",
]
