#!/usr/bin/env python
"""How far f32 rounding alone moves the uc rolling-horizon CLI's outer
bound at 2 hub rows, on the CPU (the port only).

    python tools/uc_mpc_rounding.py

Runs the port's CLI on the uc horizon's recipe at tests/test_mpc.py's
size (2 units, 4 hours, 3 scenarios, --max-iterations 1) at window 0 and
at window 1 (--uc-mpc-step 1 --uc-mpc-stride 1), then window 1 again
with every scenario's demand scaled by 1 +/- 1 ulp and 1 + 2 ulp of f32,
and prints each outer bound and its relative distance from the unscaled
window 1's.  chip_smoke.py's [mpc_uc_cli] sets its tolerance from this
spread: a bound that moves this much for a 1-ulp change of its data
moves as much for a change of summation order (the card's against the
CPU's).
"""
import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpisppy_tpu_torch import generic_cylinders  # noqa: E402
from mpisppy_tpu_torch.models import uc  # noqa: E402
from mpisppy_tpu_torch.mpc import uc_horizon  # noqa: E402


def outer(step):
    args = uc_horizon(2, 4, 1, max_step_iterations=1).step_argv(step)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generic_cylinders.main(args + ["--device", "cpu"])
    return json.loads(buf.getvalue().strip().splitlines()[-1])["outer_bound"]


def main():
    torch.set_num_threads(2)
    ref = outer(1)
    print(json.dumps({"step": 0, "outer": outer(0)}))
    print(json.dumps({"step": 1, "demand_scale_ulps": 0, "outer": ref}))
    real = uc._mpc_demand
    try:
        for ulps in (1, -1, 2):
            scale = np.float32(1.0 + ulps * 2.0 ** -23)

            def scaled(inst, k, scale=scale):
                d = real(inst, k)
                return (d * scale).astype(d.dtype)
            uc._mpc_demand = scaled
            ob = outer(1)
            print(json.dumps({"step": 1, "demand_scale_ulps": ulps,
                              "outer": ob,
                              "rel_diff": abs(ob - ref) / abs(ref)}))
    finally:
        uc._mpc_demand = real


if __name__ == "__main__":
    main()
