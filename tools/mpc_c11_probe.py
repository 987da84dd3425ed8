#!/usr/bin/env python
"""ROADMAP C11 on the CPU: the rolling-horizon driver on ccopf --soc at a
(B, B) tree, in the JAX package or in the port.

    JAX_PLATFORMS=cpu python tools/mpc_c11_probe.py jax 10
    python tools/mpc_c11_probe.py port 10

Runs RollingDriver(ccopf_horizon(soc=True)) with --branching-factors B B
--num-scens B*B after the recipe for 3 windows (step 0 cold, then warm
from the shifted plane) and prints per window the outer and inner
bounds, hub iterations, the warm / cold-fallback / degraded flags and
the seconds since the start.  Each run imports one package only.  Keep
B small: (100,100) is the full-size tree and belongs on the card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(which, bf):
    args = ("--branching-factors", str(bf), str(bf), "--num-scens",
            str(bf * bf))
    t0 = time.perf_counter()
    if which == "jax":
        from mpisppy_tpu.mpc import RollingDriver, ccopf_horizon
        drv = RollingDriver(ccopf_horizon(soc=True, extra_args=args))
    elif which == "port":
        import torch
        torch.set_num_threads(2)
        from mpisppy_tpu_torch.mpc import RollingDriver, ccopf_horizon
        drv = RollingDriver(ccopf_horizon(soc=True, extra_args=args),
                            device="cpu")
    else:
        raise SystemExit("usage: mpc_c11_probe.py {jax|port} B")
    for r in drv.stream(3):
        print(which, bf, json.dumps({
            "step": r.step, "outer": r.outer, "inner": r.inner,
            "iterations": r.iterations, "warm": r.warm,
            "cold_fallback": r.cold_fallback, "degraded": r.degraded,
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
