###############################################################################
# mpisppy_tpu_torch.serve — the multi-tenant wheel server (port of
# mpisppy_tpu/serve; docs/serving.md describes the JAX package's, whose
# wire protocol, lifecycle and policies this package keeps).
#
#   protocol  — JSON-lines wire protocol (SubmitRequest, SLA classes,
#               terminal-outcome vocabulary)
#   session   — session lifecycle (QUEUED -> ADMITTED -> RUNNING ->
#               DEGRADED -> DONE/FAILED, REJECTED) with per-session
#               telemetry bus scoping (one JSONL trace per session)
#   admission — weighted fair queueing across tenants, SLA priority
#               classes, per-tenant quotas, typed backpressure
#               (AdmissionRejected — never a hang)
#   multiplex — cross-session megabatch coalescing (shared-structure
#               interning over the dispatch scheduler's mergeable
#               identities) + the ExchangeRing interleaving sessions'
#               host exchanges on the async hub
#   engine    — WheelEngine (a session = one fused wheel built through
#               the generic_cylinders recipe) + SyntheticEngine (the
#               load/chaos test double)
#   server    — the long-lived WheelServer process
#   loadgen   — ServeClient + the p50/p99 / tenant-isolation load
#               harness behind bench.py's serve_load phase
#
# Start one:  python -m mpisppy_tpu_torch.serve --unix /tmp/wheel.sock
# (sessions run on the CUDA device; --device cpu serves on the CPU)
###############################################################################
from mpisppy_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionRejected,
    FairQueue,
    FleetAdmission,
)
from mpisppy_tpu_torch.serve.protocol import (  # noqa: F401
    MODELS,
    SLA_CLASSES,
    ProtocolError,
    SubmitRequest,
)
from mpisppy_tpu_torch.serve.server import ServeOptions, WheelServer  # noqa: F401
from mpisppy_tpu_torch.serve.session import Session  # noqa: F401
