#!/usr/bin/env python
"""The JAX package's fused PH wheel on ccopf --soc, as the reference the
PyTorch port's wheel is held to (chip_smoke.py's [ccopf_soc] phase).

    JAX_PLATFORMS=cpu python tools/ccopf_soc_jax_reference.py 100 100

Runs WheelSpinner(hub_dict, spokes).spin() with the FusedPH hub and the
fused Lagrangian and x̂-x̄ spokes on the default 4-bus feeder over the
given branching factors, with tests/test_cones.py's options (rho 10,
PDHG tol 1e-6, rel_gap 1%, at most 80 iterations), and prints one JSON
line: iterations, outer and inner bounds, rel_gap and wall seconds.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpisppy_tpu.algos import fused_wheel as fw  # noqa: E402
from mpisppy_tpu.algos import ph as ph_mod  # noqa: E402
from mpisppy_tpu.core import batch as batch_mod  # noqa: E402
from mpisppy_tpu.cylinders import spoke  # noqa: E402
from mpisppy_tpu.cylinders.hub import PHHub  # noqa: E402
from mpisppy_tpu.models import ccopf  # noqa: E402
from mpisppy_tpu.ops import pdhg  # noqa: E402
from mpisppy_tpu.spin_the_wheel import WheelSpinner  # noqa: E402


def main(argv) -> int:
    bfs = tuple(int(b) for b in argv[1:3]) if len(argv) >= 3 else (3, 3)
    specs = [ccopf.scenario_creator(nm, branching_factors=bfs, soc=True)
             for nm in ccopf.scenario_names_creator(bfs[0] * bfs[1])]
    batch = batch_mod.from_specs(specs, tree=ccopf.make_tree(bfs))
    opts = ph_mod.PHOptions(default_rho=10.0, max_iterations=80,
                            conv_thresh=0.0,
                            pdhg=pdhg.PDHGOptions(tol=1e-6))
    hub = {"hub_class": PHHub, "hub_kwargs": {"options": {"rel_gap": 1e-2}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions()}}
    spokes = [{"spoke_class": spoke.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke.FusedXhatXbarInnerBound,
               "opt_kwargs": {"options": {}}}]
    t0 = time.perf_counter()
    ws = WheelSpinner(hub, spokes).spin()
    secs = time.perf_counter() - t0
    print(json.dumps({
        "model": "ccopf_soc", "bfs": list(bfs), "iterations": ws.spcomm._iter,
        "outer": ws.BestOuterBound, "inner": ws.BestInnerBound,
        "rel_gap": ws.spcomm.compute_gaps()[1], "seconds": secs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
