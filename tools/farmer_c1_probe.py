#!/usr/bin/env python
"""Where the farmer fused wheel of the PyTorch port and of the JAX
package part ways (ROADMAP.md queue C, item 1), on the CPU.

    JAX_PLATFORMS=cpu python tools/farmer_c1_probe.py [--sweep]

Farmer's per-scenario A runs the plain PDHG iteration in both packages.
From the same state (carried across with mpisppy_tpu_torch.convert) it
prints, for the 3-scenario batch at PDHG tol 1e-6:
  * one iteration from a mid-solve state (three JAX windows in): max
    |dx| between the packages and max |x| (the per-iteration noise);
  * per restart window of iter0 from the initial state, the restart
    scores of both packages and the largest difference between the two
    packages' kkt_residuals on the SAME iterates (the scoring functions
    themselves);
and with --sweep, the hub iterations and bounds of the four-spoke fused
wheel (tests/test_fused_wheel.py's options, monolithic dispatch) at
S = 3, 6, 12, 24, 48 and farmer seedoffsets 0 and 1: JAX, the port, and
the port with the JAX norm estimate.  Like the tests, it imports both
packages; the port itself never imports JAX.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpisppy_tpu.algos import fused_wheel as jfw  # noqa: E402
from mpisppy_tpu.algos import ph as jph  # noqa: E402
from mpisppy_tpu.core import batch as jbatch  # noqa: E402
from mpisppy_tpu.cylinders import spoke as jspoke  # noqa: E402
from mpisppy_tpu.cylinders.hub import PHHub as JHub  # noqa: E402
from mpisppy_tpu.models import farmer  # noqa: E402
from mpisppy_tpu.ops import boxqp as jboxqp  # noqa: E402
from mpisppy_tpu.ops import pdhg as jpdhg  # noqa: E402
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWS  # noqa: E402
from mpisppy_tpu_torch import convert  # noqa: E402
from mpisppy_tpu_torch.algos import fused_wheel as tfw  # noqa: E402
from mpisppy_tpu_torch.algos import ph as tph  # noqa: E402
from mpisppy_tpu_torch.cylinders import spoke as tspoke  # noqa: E402
from mpisppy_tpu_torch.cylinders.hub import PHHub as THub  # noqa: E402
from mpisppy_tpu_torch.ops import boxqp as tboxqp  # noqa: E402
from mpisppy_tpu_torch.ops import pdhg as tpdhg  # noqa: E402
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWS  # noqa: E402

torch.set_num_threads(1)


def batches(S, seedoffset=0):
    jb = jbatch.from_specs([
        farmer.scenario_creator(nm, num_scens=S, seedoffset=seedoffset)
        for nm in farmer.scenario_names_creator(S)])
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def jax_norm(p, iters=30, generator=None):
    arrs = convert.arrays_of(p)
    jp = jboxqp.BoxQP(**{k: jnp.asarray(arrs[k])
                         for k in ("c", "q", "A", "bl", "bu", "l", "u")})
    return torch.as_tensor(np.array(jpdhg.estimate_norm(jp, iters)))


def iter0_windows(windows=20):
    jb, tb = batches(3)
    jo, to = jpdhg.PDHGOptions(tol=1e-6), tpdhg.PDHGOptions(tol=1e-6)
    jwin = jax.jit(jpdhg._window, static_argnames=("opts",))
    # one iteration from a mid-solve state (three JAX windows in)
    mid = jpdhg.init_state(jb.qp, jo)
    for _ in range(3):
        mid = jwin(jb.qp, mid, jo)
    tau = jo.step_margin * mid.omega / mid.Lnorm
    sigma = jo.step_margin / (mid.omega * mid.Lnorm)
    j1 = jax.jit(jpdhg._pdhg_iter)(jb.qp, mid, tau, sigma)
    t1 = tpdhg._pdhg_iter(
        tb.qp, convert.pdhg_state_from_arrays(convert.arrays_of(mid), "cpu"),
        torch.as_tensor(np.array(tau)), torch.as_tensor(np.array(sigma)))
    dx = np.abs(np.asarray(j1.x) - t1.x.numpy()).max()
    print(f"one iteration: max|dx| {dx:.3e}  "
          f"max|x| {float(jnp.abs(j1.x).max()):.4g}")
    jst = jpdhg.init_state(jb.qp, jo)
    tst = convert.pdhg_state_from_arrays(convert.arrays_of(jst), "cpu")
    for w in range(windows):
        jst = jwin(jb.qp, jst, jo)
        tst = tpdhg._window(tb.qp, tst, to)
        same = [np.abs(a.numpy() - np.asarray(b)).max() for a, b in zip(
            tboxqp.kkt_residuals(tb.qp, torch.as_tensor(np.array(jst.x)),
                                 torch.as_tensor(np.array(jst.y))),
            jboxqp.kkt_residuals(jb.qp, jst.x, jst.y))]
        print(f"window {w:2d}  jax {np.asarray(jst.score)}  "
              f"port {tst.score.numpy()}  kkt on the same iterates "
              f"differs by {max(same):.2e}")


def wheel(fw, ph, pdhg, sp, hub, spinner, batch):
    wopts = fw.FusedWheelOptions(
        slam_windows=2, shuffle_windows=4, slam_sense_max=False,
        split_dispatch=False, lag_pdhg=pdhg.PDHGOptions(tol=1e-7),
        xhat_pdhg=pdhg.PDHGOptions(tol=1e-7, omega0=0.1, restart_period=80))
    opts = ph.PHOptions(default_rho=1.0, max_iterations=150,
                        conv_thresh=0.0, subproblem_windows=10,
                        pdhg=pdhg.PDHGOptions(tol=1e-7))
    h = {"hub_class": hub, "hub_kwargs": {"options": {"rel_gap": 5e-3}},
         "opt_class": fw.FusedPH,
         "opt_kwargs": {"options": opts, "batch": batch,
                        "wheel_options": wopts}}
    spokes = [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        sp.FusedLagrangianOuterBound, sp.FusedXhatXbarInnerBound,
        sp.FusedXhatShuffleInnerBound, sp.FusedSlamHeuristic)]
    w = spinner(h, spokes).spin()
    return f"{w.spcomm._iter} ({w.BestOuterBound:.1f}, {w.BestInnerBound:.1f})"


def sweep():
    own = tpdhg.estimate_norm
    for seedoffset in (0, 1):
        for S in (3, 6, 12, 24, 48):
            jb, tb = batches(S, seedoffset)
            j = wheel(jfw, jph, jpdhg, jspoke, JHub, JWS, jb)
            t = wheel(tfw, tph, tpdhg, tspoke, THub, TWS, tb)
            tpdhg.estimate_norm = jax_norm
            tj = wheel(tfw, tph, tpdhg, tspoke, THub, TWS, tb)
            tpdhg.estimate_norm = own
            print(f"seedoffset {seedoffset} S={S:2d}  jax {j}  port {t}  "
                  f"port with the JAX norm {tj}", flush=True)


if __name__ == "__main__":
    iter0_windows()
    if "--sweep" in sys.argv[1:]:
        sweep()
