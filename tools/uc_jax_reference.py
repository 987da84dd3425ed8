#!/usr/bin/env python
"""The JAX package's reference numbers that chip_smoke.py's uc and
normal phases hold the port to, computed on the CPU.

    JAX_PLATFORMS=cpu python tools/uc_jax_reference.py [S] [HUB_ITERS] [FWPH_ITERS] [ITER0_WINDOWS]

Prints (defaults S=100, 25 hub iterations, 5 FWPH outer iterations, 400
cold windows for PH's iter0 and FWPH's init):
  * the power iteration's ||A|| estimate of farmer S=3
    (mpisppy_tpu.ops.pdhg.estimate_norm, from jax.random.normal(PRNGKey(7)));
  * bench.py's bench_uc_fwph wheel (PH hub with SepRho(multiplier=2), the
    FWPH spoke at rho 200, the fused Lagrangian, x̂-x̄ and slam planes,
    spoke_sync_period 5) on uc 10x24 at S scenarios, capped at HUB_ITERS
    hub iterations: its outer and inner bounds;
  * bench.py's bench_uc_fwph_hub loop (FWPH driving, x̂ from x̄ rounded
    to nearest and up every 5th outer iteration, gated by comp_tight)
    capped at FWPH_ITERS outer iterations: its certified outer bound and
    its inner bound.
Imports only the JAX package; the port is not involved.
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpisppy_tpu.algos import fused_wheel as fw  # noqa: E402
from mpisppy_tpu.algos import fwph  # noqa: E402
from mpisppy_tpu.algos import ph as ph_mod  # noqa: E402
from mpisppy_tpu.algos import xhat  # noqa: E402
from mpisppy_tpu.core import batch as batch_mod  # noqa: E402
from mpisppy_tpu.cylinders import spoke  # noqa: E402
from mpisppy_tpu.cylinders.hub import PHHub  # noqa: E402
from mpisppy_tpu.extensions.rho_setters import SepRho  # noqa: E402
from mpisppy_tpu.models import farmer, uc  # noqa: E402
from mpisppy_tpu.ops import pdhg  # noqa: E402
from mpisppy_tpu.spin_the_wheel import WheelSpinner  # noqa: E402


def uc_batch(S):
    inst = uc.synthetic_instance(10, 24, seed=0)
    return batch_mod.from_specs([
        uc.scenario_creator(nm, instance=inst, num_scens=S)
        for nm in uc.scenario_names_creator(S)])


def uc_wheel(S, hub_iters, iter0_windows=400):
    opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=hub_iters, conv_thresh=0.0,
        subproblem_windows=10, iter0_windows=iter0_windows,
        pdhg=pdhg.PDHGOptions(tol=1e-6, restart_period=40,
                              iter_precision="bf16x3"))
    spoke_pdhg = pdhg.PDHGOptions(tol=1e-6, max_iters=4_000)
    spokes = [{"spoke_class": spoke.FWPHOuterBound,
               "opt_kwargs": {"options": {
                   "rho": 200.0, "pdhg_opts": spoke_pdhg,
                   "fw_opts": fwph.FWPHOptions(
                       iter0_windows=iter0_windows)}}}]
    spokes += [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        spoke.FusedLagrangianOuterBound, spoke.FusedXhatXbarInnerBound,
        spoke.FusedSlamHeuristic)]
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 0.01,
                                      "spoke_sync_period": 5}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": uc_batch(S),
                          "wheel_options": fw.FusedWheelOptions(
                              slam_windows=2),
                          "extensions": functools.partial(
                              SepRho, multiplier=2.0)}}
    ws = WheelSpinner(hub, spokes).spin()
    return ws.spcomm._iter, ws.BestOuterBound, ws.BestInnerBound


def uc_fwph_hub(S, outer_iters, iter0_windows=400):
    batch = uc_batch(S)
    opts = fwph.FWPHOptions(
        fw_iter_limit=2, max_columns=16, max_iterations=outer_iters,
        conv_thresh=0.0, default_rho=200.0, oracle_windows=10,
        iter0_windows=iter0_windows,
        pdhg=pdhg.PDHGOptions(tol=1e-6, restart_period=40))
    xhat_opts = pdhg.PDHGOptions(tol=1e-6, max_iters=4_000)
    drv = fwph.FWPH(opts, batch)
    drv.fw_prep()
    outer, inner = drv.best_bound, float("inf")
    for itr in range(1, outer_iters + 1):
        drv.state = fwph.fwph_iter(batch, drv.state, opts)
        outer = max(outer, float(drv.state.best_bound))
        if itr % 5 == 0:
            for mode in ("nearest", "ceil"):
                cand = xhat.round_integers(batch, drv.state.xbar_nodes, mode)
                res = xhat.evaluate(batch, cand, xhat_opts)
                if bool(res.feasible) and xhat.comp_tight(batch, res):
                    inner = min(inner, float(res.value))
    return outer, inner


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    hub_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    fwph_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    iter0 = int(sys.argv[4]) if len(sys.argv) > 4 else 400
    fb = batch_mod.from_specs([farmer.scenario_creator(nm, num_scens=3)
                               for nm in farmer.scenario_names_creator(3)])
    print("farmer_S3_norm", [float(v) for v in pdhg.estimate_norm(fb.qp)],
          flush=True)
    t0 = time.perf_counter()
    iters, outer, inner = uc_wheel(S, hub_iters, iter0)
    print(f"uc_wheel S={S} hub_iters={iters} outer={outer!r} "
          f"inner={inner!r} s={time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    outer, inner = uc_fwph_hub(S, fwph_iters, iter0)
    print(f"uc_fwph_hub S={S} outer_iters={fwph_iters} outer={outer!r} "
          f"inner={inner!r} s={time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
