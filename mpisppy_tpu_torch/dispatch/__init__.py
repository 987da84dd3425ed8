###############################################################################
# Dispatch subsystem: the one gate between host-driven solve loops and
# the device (port of mpisppy_tpu/dispatch).
#
#   * buckets.py      — the shape-bucket ladder + batch-axis padding;
#   * compilewatch.py — the process-wide compile counter (kernel-library
#     builds and first-seen padded shape signatures);
#   * scheduler.py    — the coalescing queue (max-wait/max-batch
#     admission), the bounded in-flight semaphore, the fault domain, and
#     the process-default scheduler every MIP oracle routes through.
###############################################################################
from mpisppy_tpu_torch.dispatch.buckets import (   # noqa: F401
    BucketLadder,
    default_ladder,
    pad_qp_batch,
    slice_result,
)
from mpisppy_tpu_torch.dispatch.compilewatch import CompileWatch  # noqa: F401
from mpisppy_tpu_torch.dispatch.scheduler import (  # noqa: F401
    DispatchContext,
    DispatchOptions,
    PlaneTicket,
    SolveFailed,
    SolveScheduler,
    SolveTicket,
    clear_session_context,
    configure,
    current_context,
    current_hub_iter,
    from_cfg,
    get_scheduler,
    scheduler_stats,
    set_hub_iter,
    set_session_context,
    solve_mip,
)
