#!/usr/bin/env python
"""The JAX package's rolling-horizon numbers that chip_smoke.py's
[mpc_ccopf] and [mpc_uc_cli] phases hold the port to, computed on the
CPU.

    JAX_PLATFORMS=cpu python tools/mpc_jax_reference.py

Prints:
  * the JAX RollingDriver on ccopf_horizon(soc=True) at the (3, 3) tree,
    given the port's --convthresh 0 (its recipe stops only on the gap,
    ROADMAP C1), for MPC_STEPS windows (step 0 cold, then warm from the
    shifted plane): per step the outer and inner bounds, hub iterations
    and the warm / cold-fallback / degraded flags;
  * the JAX CLI on the uc horizon's recipe at tests/test_mpc.py's size
    (2 units, 4 hours, 3 scenarios) with --uc-mpc-step 1 --uc-mpc-stride
    1 --max-iterations 1: its JSON line; and the same at window 0 (the
    bound the step must move away from).
Imports only the JAX package; the port is not involved.
"""
import contextlib
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpisppy_tpu import generic_cylinders  # noqa: E402
from mpisppy_tpu.mpc import (  # noqa: E402
    RollingDriver, ccopf_horizon, uc_horizon,
)

MPC_STEPS = 3          # chip_smoke.py keeps the same number
UC_STEP = 1


def main():
    t0 = time.perf_counter()
    steps = [{"step": r.step, "outer": r.outer, "inner": r.inner,
              "iterations": r.iterations, "warm": r.warm,
              "cold_fallback": r.cold_fallback, "degraded": r.degraded}
             for r in RollingDriver(ccopf_horizon(
                 soc=True, extra_args=("--convthresh", "0")))
             .stream(MPC_STEPS)]
    print("MPC_CCOPF_SMALL_JAX =", json.dumps(steps))
    for step, name in ((UC_STEP, "MPC_UC_CLI_JAX"),
                       (0, "MPC_UC_CLI_JAX_STEP0")):
        args = uc_horizon(2, 4, 1, max_step_iterations=1).step_argv(step)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            generic_cylinders.main(args)
        print(name, "=", buf.getvalue().strip().splitlines()[-1])
    print(f"# {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
