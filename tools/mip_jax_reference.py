#!/usr/bin/env python
"""The JAX package's reference numbers that chip_smoke.py's MIP phases
hold the port to, computed on the CPU.

    JAX_PLATFORMS=cpu python tools/mip_jax_reference.py [S [ROUNDS
        [NODE_MAX_ITERS [DIVE_TAIL [PUMP_ROUNDS]]]]]

Prints (defaults: S=10, SIPLIB sslp_15_45_10's dimensions, and the
budgets below, chip_smoke.py's):
  * mip.certified_mip_gap on synthetic sslp 15x45 (instance seed 0,
    integer recourse) at S scenarios with the [mip_gap] budgets: PH
    MIP_GAP_PH_ITERS iterations at rho MIP_GAP_RHO, BnBOptions(max_rounds=
    MIP_GAP_MAX_ROUNDS, pool_size=MIP_GAP_POOL, dive_tail=MIP_GAP_DIVE_TAIL,
    pump_rounds=MIP_GAP_PUMP_ROUNDS, node LPs capped at MIP_NODE_MAX_ITERS
    iterations), dd_nodes MIP_GAP_DD_NODES: its inner and outer bounds,
    gap and seconds;
  * the JAX CLI's --EF on farmer with 3 scenarios: its EF_objective.
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
from mpisppy_tpu.algos import mip, ph as ph_mod  # noqa: E402
from mpisppy_tpu.core import batch as batch_mod  # noqa: E402
from mpisppy_tpu.models import sslp  # noqa: E402
from mpisppy_tpu.ops import pdhg  # noqa: E402
from mpisppy_tpu.ops.bnb import BnBOptions  # noqa: E402

# the [mip_gap] budgets (chip_smoke.py keeps the same numbers)
MIP_GAP_PH_ITERS = 10
MIP_GAP_RHO = 10.0
MIP_GAP_MAX_ROUNDS = 1
MIP_GAP_POOL = 32
MIP_GAP_DIVE_TAIL = 16
MIP_GAP_PUMP_ROUNDS = 2
MIP_GAP_DD_NODES = 1
MIP_NODE_MAX_ITERS = 400
CLI_EF = ["--module-name", "mpisppy_tpu.models.farmer", "--num-scens", "3",
          "--EF"]


def sslp_mip_batch(S):
    inst = sslp.synthetic_instance(15, 45, seed=0)
    return batch_mod.from_specs([
        sslp.scenario_creator(nm, instance=inst, num_scens=S)
        for nm in sslp.scenario_names_creator(S)])


def mip_gap(S, rounds, node_max_iters, dive_tail, pump_rounds):
    batch = sslp_mip_batch(S)
    t0 = time.perf_counter()
    res = mip.certified_mip_gap(
        batch, ph_mod.PHOptions(max_iterations=MIP_GAP_PH_ITERS,
                                default_rho=MIP_GAP_RHO),
        BnBOptions(max_rounds=rounds, pool_size=MIP_GAP_POOL,
                   dive_tail=dive_tail, pump_rounds=pump_rounds,
                   lp=pdhg.PDHGOptions(tol=1e-5, max_iters=node_max_iters)),
        dd_nodes=MIP_GAP_DD_NODES)
    return res, time.perf_counter() - t0


def cli_ef():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        generic_cylinders.main(list(CLI_EF))
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main():
    args = [int(a) for a in sys.argv[1:]]
    budgets = args + [10, MIP_GAP_MAX_ROUNDS, MIP_NODE_MAX_ITERS,
                      MIP_GAP_DIVE_TAIL, MIP_GAP_PUMP_ROUNDS][len(args):]
    ef = cli_ef()
    print(f"cli_ef EF_objective={ef['EF_objective']!r} "
          f"converged={ef['converged']}", flush=True)
    res, secs = mip_gap(*budgets)
    print(f"mip_gap S,rounds,node_max_iters,dive_tail,pump_rounds="
          f"{budgets} inner={res.inner!r} outer={res.outer!r} "
          f"gap={res.gap!r} s={secs:.1f}", flush=True)


if __name__ == "__main__":
    main()
