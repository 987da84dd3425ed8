#!/usr/bin/env python
"""ROADMAP C11 on the CPU: the rolling-horizon driver on ccopf --soc at a
(B, B) tree, in the JAX package or in the port.

    JAX_PLATFORMS=cpu python tools/mpc_c11_probe.py jax 10
    python tools/mpc_c11_probe.py port 10

Runs RollingDriver(ccopf_horizon(soc=True)) with --branching-factors B B
--num-scens B*B after the recipe for 3 windows (step 0 cold, then warm
from the shifted plane) and prints per window the outer and inner
bounds, hub iterations, the warm / cold-fallback / degraded flags and
the seconds since the start.  With --cold, every window that kept its
warm start is solved again cold, and its line carries the cold solve's
bounds, hub iterations and seconds beside the warm one's.  Each run
imports one package only.  The port's ccopf recipe stops only on the
gap (--convthresh 0, ROADMAP C1); pass --convthresh 0 to give the JAX
horizon the same recipe.  Keep B small: (100,100) is the full-size tree
and belongs on the card.

    python tools/mpc_c11_probe.py port 10 --cold
    JAX_PLATFORMS=cpu python tools/mpc_c11_probe.py jax 10 --convthresh 0
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(which, bf, extra=(), cold=False):
    args = ("--branching-factors", str(bf), str(bf), "--num-scens",
            str(bf * bf)) + tuple(extra)
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
    t_prev = t0
    for r in drv.stream(3):
        row = {"step": r.step, "outer": r.outer, "inner": r.inner,
               "iterations": r.iterations, "warm": r.warm,
               "cold_fallback": r.cold_fallback, "degraded": r.degraded,
               "window_s": round(time.perf_counter() - t_prev, 1)}
        if cold and r.warm:
            t1 = time.perf_counter()
            c = drv.run_step(r.step, warm_plane=None)
            row.update(cold_outer=c.outer, cold_inner=c.inner,
                       cold_iterations=c.iterations,
                       cold_degraded=c.degraded,
                       cold_window_s=round(time.perf_counter() - t1, 1))
        row["seconds"] = round(time.perf_counter() - t0, 1)
        t_prev = time.perf_counter()
        print(which, bf, json.dumps(row), flush=True)


if __name__ == "__main__":
    rest = sys.argv[3:]
    main(sys.argv[1], int(sys.argv[2]),
         extra=[a for a in rest if a != "--cold"], cold="--cold" in rest)
