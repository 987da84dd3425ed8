###############################################################################
# Batch-size bucket ladder (port of the ladder in
# mpisppy_tpu/dispatch/buckets.py).
#
# The fused wheel's straggler-tail gather (algos/fused_wheel.py
# _tail_rescue) quantizes its sub-batch size down this geometric ladder,
# so every scenario count lands on a handful of gather shapes — the same
# sizes the JAX package picks, which keeps the two ports' trajectories
# comparable.
###############################################################################
from __future__ import annotations


class BucketLadder:
    """Geometric batch-size rungs: 1, ceil(g), ceil(g^2), ... (strictly
    increasing; growth g < 2 still steps by at least 1)."""

    def __init__(self, growth: float = 2.0, min_bucket: int = 1):
        if growth <= 1.0:
            raise ValueError(f"bucket growth must exceed 1 ({growth})")
        self.growth = float(growth)
        self.min_bucket = max(1, int(min_bucket))

    def _next(self, r: int) -> int:
        return max(r + 1, int(-(-r * self.growth // 1)))

    def bucket_floor(self, size: int) -> int:
        """Largest rung <= size (for sub-batch gathers that must not
        exceed the source batch)."""
        if size <= 0:
            raise ValueError(f"bucket size must be positive ({size})")
        r = prev = self.min_bucket
        while r <= size:
            prev = r
            r = self._next(r)
        return prev


_DEFAULT_LADDER = BucketLadder()


def default_ladder() -> BucketLadder:
    return _DEFAULT_LADDER
