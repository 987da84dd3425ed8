"""Time the resident SOC window at every tile it offers, on one GPU.

    python3 tools/soc_tile_sweep.py

For the ccopf --soc batch (the 4-bus feeder, n = 81, m = 69) at
S = 10,000 (40 iterations) and at the fused wheel's straggler tail
(S = 64, 160 iterations), and in f32 and bf16x3, it times the resident
cone kernel with each tile of pdhg_window.CONE_TILES forced (the shape
rule's grid for that tile), in turns (ascending, then descending), and
the streamed design beside them, and marks the tile the shape rule
picks.  One line per (S, mode); the card's name and power limit first.
It is the measurement behind the rule's choice of tile; chip_smoke.py
times only the rule's.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mpisppy_tpu_torch.ops import pdhg_window as pw  # noqa: E402


def forced_tile(tile, fn):
    """fn() with the cone design offering only `tile`."""
    tiles = pw.CONE_TILES
    pw.CONE_TILES = (tile,)
    try:
        return fn()
    finally:
        pw.CONE_TILES = tiles


def main() -> int:
    if not torch.cuda.is_available():
        print("soc_tile_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    pw.build()
    big = cs.window_inputs(cs.ccopf_batch(cs.CCOPF_BFS, dev))
    tail = cs.window_inputs(cs.ccopf_batch((8, 8), dev),
                            seed=1)[:8] + (cs.TAIL_ITERS,)
    limits = pw.card_limits(torch.cuda.current_device())
    for args, reps in ((big, 5), (tail, 20)):
        qp = args[0]
        S = args[1].shape[0]
        _, rows = qp.cones.csr(dev)
        cone_ints = qp.cones.num_cones + 1 + rows.numel() + qp.m
        for mode in ("f32", "bf16x3"):
            rule = pw.plan_window(mode, qp.m, qp.n, S, *limits,
                                  cone_ints=cone_ints)
            ms = {t: [] for t in pw.CONE_TILES}
            plans = {}
            for t in pw.CONE_TILES + tuple(reversed(pw.CONE_TILES)):
                plans[t] = forced_tile(t, lambda: pw.plan_window(
                    mode, qp.m, qp.n, S, *limits, cone_ints=cone_ints))
                ms[t].append(forced_tile(t, lambda: cs.time_ms(
                    lambda: pw.run_window(*args, precision=mode),
                    reps=reps)))
            streamed = cs.time_ms(lambda: pw.run_window(
                *args, precision=mode, design="streamed"), reps=reps)
            cs.phase("soc_tile_sweep", S=S, mode=mode, n_iters=args[8],
                     rule_tile=rule.tile, streamed_ms=round(streamed, 4),
                     **{f"T{t}_ms": "/".join(f"{v:.4f}" for v in ms[t])
                        for t in pw.CONE_TILES},
                     **{f"T{t}_blocks": plans[t].blocks
                        for t in pw.CONE_TILES})
    return 0


if __name__ == "__main__":
    sys.exit(main())
