"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, started together) and drives its main paths:

* sslp — holds the box-row kernel in both designs (resident: A in shared
  memory, bf16x3 on tensor cores; streamed: A from L2) against its plain
  PyTorch version at the main path's shapes (S=10,000 and the
  64-scenario, 160-iteration straggler tail), measures the tensor cores'
  accumulation error, times both designs in turns, runs a small wheel on
  the card and on the CPU and compares their bounds, profiles a capped
  headline run, then drives the headline workload, the sslp 15x45 fused
  PH wheel at 10,000 scenarios, and checks that every box window took
  the design the shape rule gives;
* ccopf --soc — the branch-flow SOCP relaxation of AC power flow on a
  3-stage tree: holds the SOC window (resident: A in shared memory,
  tiles sized to the shape; streamed: A from L2) against its plain
  version (ccopf at 10,000 scenarios and the 64-scenario, 160-iteration
  tail in the design the shape rule gives, the 33-bus feeder on the
  streamed design), times both designs in turns, runs the (3,3) wheel on
  the card and on the CPU, profiles a capped (100,100) wheel, then drives
  the (100,100) wheel at 10,000 scenarios and checks that every SOC
  window took the resident design;
* scengen — seeded scenario synthesis: builds the sslp 15x45 program's
  VirtualBatch at 1,000,000 scenarios, holds the kernel's SYNTH
  instantiation (draws its bound rows in-kernel) bit for bit against the
  box kernel on the realized batch at 100,000 and 1,000,000 scenarios and
  against its plain version, times both, runs an S=64 VirtualBatch wheel
  on the card, over the materialized batch and on the CPU, then drives
  the sslp 15x45 VirtualBatch wheel at 10,000 scenarios for 10 hub
  iterations;
* farmer — per-scenario A (yields enter A), so every window runs the
  plain batched iteration and no kernel: the fused wheel with all four
  fusable spokes at 3 scenarios on the card and on the CPU (bounds
  agree, inner bound at the EF value), then the farmer program's
  VirtualBatch wheel at 10,000 scenarios to a 1% certificate;
* normal — the power iteration's start vector: the XLA-exact normal
  drawn on the card against the same draw on the CPU (in ulps), and the
  farmer S=3 norm estimate on the card against the CPU's and the JAX
  package's;
* uc — unit commitment, a sparse (ELL) constraint matrix that runs the
  plain batched iteration and no kernel: ELL products and one window on
  the card against the CPU, window times at 100, 1,000 and 10,000
  scenarios and PyTorch launches per iteration, bench.py's
  bench_uc_fwph wheel (PH hub with SepRho, an FWPH spoke, the fused
  Lagrangian, x̂-x̄ and slam planes) at 100 scenarios capped at 1 hub
  iteration, its FWPH-driven loop (bench_uc_fwph_hub) capped at 1,
  and the uc program's VirtualBatch at 10,000 scenarios for 1 hub
  iteration with a short profile;
* the CLI — generic_cylinders.main in this process, as
  `python -m mpisppy_tpu_torch` runs it: the README's sslp command
  without --presolve (cut to 2 hub iterations) and with it (also cut to 2)
  against the JAX package's bounds for each, the box kernel against its plain
  version on the presolved batch's per-scenario bounds, the sslp 15x45
  headline at 10,000 scenarios with all four fusable spokes in bf16x3
  for 10 hub iterations, its box windows in the design the shape rule
  gives, and the uc model with --fwph for 1 hub iteration;
* the exact-MIP plane — sslp 15x45 with its integer recourse (a dense
  shared A: every node LP's windows in the box kernel): the kernel in
  f32 and bf16x3 against its plain version on branch-and-bound node
  operands (fixed and emptied boxes, done lanes, warm state) at 1,000
  scenarios, lagrangian_mip_bound at 1,000 scenarios with a profile of
  five bare rounds, certified_mip_gap at 10 scenarios against the JAX
  package's bracket, solve_mip, ef_mip and certified_mip_gap at small
  shapes against scipy's MILP, the dispatch scheduler (a padded solve
  against the direct one, decomposition_bnb's node fan-out, the CLI's
  --dispatch-* flags), and the CLI's --EF against the JAX CLI;
* the decomposition hubs and bound spokes — one window of each new batch
  shape against its plain version with its route (L-shaped's
  fixed-nonant subproblems, the single- and multi-cut L-shaped masters
  as one problem on the streamed design from a mid-solve state that the
  window moves, APH's prox batch, all at 1,000 scenarios, and the
  cross-scenario PH and EF views with a round of cuts installed), then
  through the CLI at sslp 15x45: the L-shaped hub with the x̂-L-shaped
  spoke and its windows per Benders iteration at 1,000 scenarios, the
  APH hub in bf16x3 with half the scenarios dispatched at 10,000 and at
  100, a PH hub with the subgradient, Lagranger, PH-OB and reduced-costs
  outer bounds at 1,000, cross-scenario cuts on sslp 5x15 with the
  augmented batch's route, each against the JAX CLI, ccopf (3,3)
  --fused-wheel --xhatxbar with the root-fixed EF on the SOC kernel
  (its window then held against its plain version), and the
  Schur-complement interior point in f64 against HiGHS;
* the async exchange wheel (algos/async_wheel.py) — bench.py's
  bench_wheel_overhead_async at sslp 15x45, S=10,000, bf16x3 (bare PH,
  the sync pair and the async pair at staleness 0/1/2 for 10 hub
  iterations: s/iter, overhead factors, the exchange halves, the host
  time blocked per iteration under a two-iteration profile, staleness 0
  equal to the sync pair row for row), the headline CLI flags with
  --async-staleness 1 --trace-jsonl for 10 hub iterations beside the
  sync headline's, the README's sslp command with --fused-wheel
  --async-staleness 1 against the JAX CLI's bounds and again with
  dropped and torn plane writes, and the ccopf (100,100) wheel at
  staleness 1 on the SOC kernel against the sync ccopf wheel's bounds;
* checkpoints and preemption — the headline wheel again with background
  checkpoints every 5 s and a fault plan that preempts it at hub
  iteration 40 (the spinner's emergency save), every snapshot re-read
  and CRC-checked, then restored into a fresh wheel and resumed to 1%
  against the uninterrupted [headline] (bounds to 1e-3; the snapshot's
  bytes, the save's and the restore's seconds, the background saves'
  cost per iteration), and the README's sslp command through
  `python -m mpisppy_tpu_torch --checkpoint-path` sent a real SIGTERM
  (exit 75, the preempted line), then rerun with --checkpoint-restore
  (rc 0, resumed at the snapshot's hub iteration + 1, its trace rows
  those of an uninterrupted run at the same cap); [lshaped_hub] runs
  with --kernel-counters and prints the subproblem solve's per-lane PDHG
  iterations and the device kernels per window with the counters on
  and off;
* the device profile — [profile_cli]: the headline's CLI flags capped at
  10 hub iterations with --profile-dir, --profile-iters 2 and
  --trace-jsonl, then `python -m mpisppy_tpu_torch.telemetry analyze` on
  the trace (the capture found through its `profile` event) and `gate`
  on the run's device_profile.json: the capture's layout, no share of a
  peak above 1.0, K2 in the device report, the export's cost and the
  seconds per hub iteration before, inside and after the window; every
  profile phase reads its busy share through the package
  (telemetry/deviceprof.py, roofline.py), from the live profile and
  from its exported file;

each wheel through WheelSpinner(hub_dict, spokes).spin(), with the launch
counts set to 0 just before it and read just after, to show that it went
through its kernel.  One line per phase; then one JSON line describing
each kernel, then the last line {"ok": true, "device": {...}}.  Any
failed check raises (exit code 1); without CUDA the script exits 2 and
prints no result.  `python3 chip_smoke.py --only headline_profile` (or
`--only ccopf_profile`, or `--only farmer_profile`: the farmer program's
wheel at 10,000 scenarios capped at 3 hub iterations) runs that profile
phase alone (to profile another tree's package with it); `--only
uc_wheel_full` runs the uc wheel to its 1% certificate (at most 600 hub
iterations) and `--only uc` the uc phases; `--only mip` runs the
exact-MIP phases and `--only mip_gap` the [mip_gap] phase alone; `--only slice9_profile` profiles the L-shaped
and APH hubs, and `--only lshaped_hub` (or aph_hub, bound_spokes,
cross_scen, cli_ccopf_fused, sc, slice9_windows, or several of these
names joined by commas) runs those phases, with `--full` at the depths
PERF.md reports (~24 min for the four hub phases); `--only async` (or
async_overhead, async_headline, async_held, async_ccopf) runs the async
wheel's phases, `--full` at 30 hub iterations for [async_overhead] and
[async_held]; `--only resilience` (or checkpoint_headline, preempt_cli)
runs the checkpoint and preemption phases ([checkpoint_headline] runs
its own [headline] first); `--only profile_cli` the device profile's
phase.
"""
import json
import math
import re
import subprocess
import sys
import time

import torch

SSLP_SERVERS, SSLP_CLIENTS = 15, 45   # bench.py SSLP_SERVERS/CLIENTS
HEADLINE_SCENS = 10_000               # bench.py SSLP_SCENS
SWEEP_SCENS = (10_000, 100_000)       # bench.py SWEEP (full run)
N_ITERS = 40                          # restart_period of the headline
TAIL_SCENS, TAIL_ITERS = 64, 160      # the fused wheel's straggler tail
DESIGNS = ("resident", "streamed")    # the window kernel's two designs
HEADLINE_MAX_ITERS = 150              # cap: a few minutes on one H100
PROFILE_HUB_ITERS = 3                 # [headline_profile]'s capped run
                                      # (cut from 6)
PROFILE_CLI_ITERS = 10                # [profile_cli]: the CLI headline's
PROFILE_CLI_WINDOW = 2                # cap and its --profile-iters
K2_KEY = "pdhg_window/bf16x3/resident"  # K2 in a device report
# kernel vs plain version, max |k - r| <= ATOL + RTOL * |r| after one
# window: f32 differs only in summation order (~1e-6 measured); bf16x3
# splits a value whose last bits differ, so its terms move by ~2^-16
TOLS = {"f32": (1e-4, 1e-4), "bf16x3": (1e-3, 1e-3)}
# ccopf --soc (tests/test_cones.py's wheel options, the fused wheel)
CCOPF_BFS = (100, 100)                # 10,000 scenarios, 101 tree nodes
CCOPF_SMALL_BFS = (3, 3)
CCOPF_MAX_ITERS = 80
CCOPF_PROFILE_HUB_ITERS = 3           # [ccopf_profile]'s capped run (the
                                      # whole wheel takes 3)
WIDE_FEEDER_BUSES, WIDE_SCENS = 33, 256   # the wider parity shape
# The JAX package's fused wheel at CCOPF_BFS on the CPU, the same options
# (tools/ccopf_soc_jax_reference.py 100 100): (outer, inner).  Its
# bounds cross by 1.9e-5 relative, inside the hub's own bound_slack
# (5e-3 relative), with which it accepted both; the port's must agree
# with them to 1e-3 relative and cross by no more than that slack.
CCOPF_JAX_BOUNDS = (72.08553314208984, 72.08416748046875)
HUB_BOUND_SLACK = 5e-3
# live duals after a window lie in the polar cone up to f32 rounding
POLAR_TOL = 1e-6
# scengen: the VirtualBatch build and the synth windows run at these
# sizes; their solver state is one mid-solve state at SCENGEN_BASE_SCENS
# tiled along the scenario axis (at 1,000,000 scenarios one (S, n) f32
# tensor is 2.8 GB, too much for a solve just to make inputs)
SCENGEN_SCENS = (100_000, 1_000_000)
SCENGEN_BASE_SCENS = 10_000
SCENGEN_SMALL_SCENS = 64
SCENGEN_WHEEL_ITERS = 10              # [scengen_wheel]'s cap (cut from a
                                      # 1% certificate, 77 iterations)
# the kernels' MODE template argument
MODE_NAMES = {"0": "f32", "1": "bf16", "3": "bf16x3"}
# farmer (per-scenario A: every window runs the plain batched iteration,
# no kernel) with tests/test_fused_wheel.py's four-spoke wheel options
FARMER_EF_OBJ = -108390.0             # the 3-scenario EF value
FARMER_SMALL_SCENS = 3
FARMER_SCENS = 10_000                 # the scengen program's VirtualBatch
FARMER_MAX_ITERS = 150
FARMER_PROFILE_HUB_ITERS = 3          # [farmer_profile]'s capped run
# the CLI, run in-process: the README's sslp command without --presolve,
# and the sslp headline at full width with all four fusable spokes
README_SSLP = ["--module-name", "mpisppy_tpu_torch.models.sslp",
               "--num-scens", "100", "--lagrangian", "--xhatshuffle",
               "--rel-gap", "0.01"]
# cut: the README command's 100 hub iterations take ~550 s on an H100 (a
# to-tolerance solve per spoke and sync) and, in the JAX package too,
# end at rel_gap 0.416 (rho 1).  Without --presolve it runs 2 hub
# iterations (cut from 3; at 3 the JAX CLI gives -216.85544/-149.89996)
CLI_README = README_SSLP + ["--max-iterations", "2"]
# the JAX package's CLI on the CPU, the same command (python -m
# mpisppy_tpu --module-name mpisppy_tpu.models.sslp ... --max-iterations
# 2): (outer, inner); the port's must agree to 1e-3 relative
CLI_README_JAX_BOUNDS = (-216.9170379638672, -149.89996337890625)
# the README command as it is (with --presolve: FBBT) cut to 2 hub
# iterations (3 before the device profile's phase, with the JAX CLI's
# -216.85530/-149.89996; 5 before the async wheel's, -216.73627; at 10
# -216.44839): the JAX package's CLI on the CPU, the same command, gives
# (outer, inner); the port's must agree to 1e-4 relative
CLI_README_PRESOLVE = README_SSLP + ["--presolve", "--max-iterations", "2"]
CLI_README_PRESOLVE_JAX_BOUNDS = (-216.91693115234375, -149.89996337890625)
# the power iteration's ||A|| estimate of farmer S=3 (Ruiz-scaled), the
# JAX package's (mpisppy_tpu.ops.pdhg.estimate_norm on the CPU, from
# jax.random.normal(PRNGKey(7))); the port's must agree to 1e-5 relative
FARMER_JAX_NORM = (2.7102075, 2.7094343, 2.7089956)
NORMAL_DRAWS = 1_000_000
# uc: bench.py's instance (10 units x 24 hours: m=1708, n=1008, k=11)
# and bench_uc_fwph's wheel at UC_SCENS (bench.py UC_SCENS)
UC_GENS, UC_HOURS = 10, 24
UC_SCENS = 100
ELL_SCENS = (100, 1_000, 10_000)
# batch sizes at which the two forms of the ELL products are timed
ELL_PRODUCT_SCENS = (100, 300, 1_000, 3_000, 10_000)
# cut from 25 to 10 hub iterations for the MIP phases, to 5 for the
# decomposition hubs', to 3 for the async wheel's and to 1 for the
# checkpoint phases: the outer bound has landed by then in both
# packages, at the same value
UC_WHEEL_HUB_ITERS = 1
UC_FULL_MAX_ITERS = 600
UC_FWPH_OUTER_ITERS = 1                 # cut from 5, then 3
UC_PROGRAM_SCENS = 10_000
UC_PROGRAM_HUB_ITERS = 1    # cut from 3: the FWPH outer bound has landed
#                             after one (ob_char F); PH's iter0 and
#                             FWPH's init are 868 of the 3 iterations'
#                             940 windows
# the JAX package on the CPU (tools/uc_jax_reference.py 100 1 1; with
# 3, 5, 10 and 25 hub iterations the same outer bound): the
# outer bound of [uc_wheel] (its inner bound has not landed by then, in
# either package) and the certified outer bound of [uc_fwph_hub]; the
# port's must agree to 1e-3 relative
UC_WHEEL_JAX_OUTER = 589529.1875
UC_FWPH_HUB_JAX_OUTER = 589529.1875     # 589529.4375 at 3, 589618.25 at 5
# the uc model through the CLI with flags the JAX CLI takes for the same
# run (python -m mpisppy_tpu --module-name mpisppy_tpu.models.uc ...)
CLI_UC = ["--module-name", "mpisppy_tpu_torch.models.uc",
          "--num-scens", str(UC_SCENS), "--fused-wheel", "--lagrangian",
          "--xhatxbar", "--slammax", "--fwph", "--rel-gap", "0.01",
          "--max-iterations", "1"]             # cut from 5, then 3
# [cli_headline] runs it for 10 hub iterations (cut from a 1%
# certificate, 77 iterations, which [headline] and [checkpoint_headline]
# reach through the same wheel), as [async_headline] and [profile_cli] do
CLI_HEADLINE_ITERS = 10
CLI_HEADLINE = ["--module-name", "mpisppy_tpu_torch.models.sslp",
                "--n-servers", str(SSLP_SERVERS), "--n-clients",
                str(SSLP_CLIENTS), "--num-scens", str(HEADLINE_SCENS),
                "--fused-wheel", "--lagrangian", "--xhatxbar",
                "--xhatshuffle", "--slammin", "--iter-precision", "bf16x3",
                "--rel-gap", "0.01",
                # the headline's own configuration (bench_sslp_gap)
                "--default-rho", "20", "--sslp-lp-relax",
                "--max-iterations", str(HEADLINE_MAX_ITERS)]

# the exact-MIP plane (ops/bnb.py, algos/mip.py, dispatch/): sslp 15x45
# with its integer recourse (n=705, m=60, 690 integer columns), a dense
# shared A, so every node LP's windows run in the box kernel
MIP_SCENS = 1_000                     # [bnb_operands], [mip_lagrangian]
MIP_RHO = 10.0                        # tests/test_mip_bnb.py's PH rho
MIP_LAG_PH_ITERS = 20                 # the short LP PH run giving W
MIP_LAG_MAX_ROUNDS = 2                # the capped B&B of [mip_lagrangian]
#                                       (cut from 60, then 20, 10, 5)
MIP_LAG_PUMP_ROUNDS = 2               # (cut from 5)
MIP_PROFILE_ROUNDS = 2                # B&B rounds under the profiler
#                                       (cut from 5)
MIP_SMALL_PH_ITERS = 5                # [mip_small]'s certified_mip_gap
#                                       PH (cut from 20, then 10)
MIP_SMALL_DD_NODES = 1                # and its decomposition nodes (cut
#                                       from 2)
# every node LP of the capped MIP phases stops at 2,000 iterations (50
# windows) instead of BnBOptions' 8,000: on the card a window with its
# restart costs ~5 ms of host launches, and the slowest lane of a round
# reached the cap in every round of the first run (200 windows, ~1 s a
# round at S=1,000).  Bounds stay certified at any iterate.
MIP_NODE_MAX_ITERS = 2_000
# the certified_mip_gap runs cap their node LPs at 800 iterations (20
# windows; [mip_gap] at 400 since the device profile's phase): at 2,000
# [mip_gap] took 277 s on the card (12 solve_mip dispatches, 38,540
# windows at ~7 ms), at 800 57-75 s (8,429 windows)
MIP_SMALL_NODE_MAX_ITERS = 800
MIP_GAP_NODE_MAX_ITERS = 400
# the MIP Lagrangian bound may lie below the LP Lagrangian bound at the
# same W by at most this much relative: both are inexact f32 solves (the
# node LPs stop at KKT 1e-5, the LP bound at 1e-6)
MIP_LP_SLACK = 1e-3
# [mip_gap]: certified_mip_gap at SIPLIB sslp_15_45_10's dimensions
# (synthetic data, instance seed 0) with these budgets, and the JAX
# package's bracket for the same run on the CPU
# (tools/mip_jax_reference.py 10 1): (inner, outer).  Cut from 10 B&B
# rounds to 3 and from 30 PH iterations to 10 to make room for the
# decomposition hubs' phases, then to 1 round for the async wheel's
# (before, the JAX bracket was 4826.35/-310.15, then 4826.34/-322.95),
# then from 4 decomposition nodes to 2 for the checkpoint phases and to
# 1 after them (the JAX bracket is the same at 1, 2 and 4), then from
# node LPs of 800 iterations to 400 for the device profile's phase (at
# 800 the JAX bracket is 4826.71/-462.94)
MIP_GAP_SCENS = 10
MIP_GAP_PH_ITERS = 10
MIP_GAP_MAX_ROUNDS, MIP_GAP_POOL, MIP_GAP_DD_NODES = 1, 32, 1
MIP_GAP_DIVE_TAIL, MIP_GAP_PUMP_ROUNDS = 16, 2
MIP_GAP_JAX = (2146.730224609375, -878.889892578125)
# the CLI's --EF on farmer, and the JAX CLI's EF objective for the same
# command on the CPU (tools/mip_jax_reference.py)
CLI_EF = ["--module-name", "mpisppy_tpu_torch.models.farmer",
          "--num-scens", "3", "--EF"]
CLI_EF_JAX_OBJ = -108390.09433410698
# the CLI with the --dispatch-* group (farmer's fused wheel: no MIP
# solve, so the scheduler's counters stay 0 and come from it)
CLI_DISPATCH = ["--module-name", "mpisppy_tpu_torch.models.farmer",
                "--num-scens", "3", "--fused-wheel", "--lagrangian",
                "--xhatxbar", "--rel-gap", "0.01", "--max-iterations", "3",
                "--dispatch-max-batch", "64", "--dispatch-timeout-s", "600"]


# slice 9: the decomposition hubs and bound spokes, each through the CLI
# in this process: sslp 15x45 (the headline's width) LP relaxation
# unless stated, each held to the JAX package's CLI on the CPU with the
# same flags (1e-3 relative), where the JAX CLI runs in minutes: at
# S=1,000 for the L-shaped hub and the bound spokes, at S=100 beside the
# APH hub's S=10,000 run.  The default run keeps the depths short (PERF.md
# §4 lists each cut); `--full` runs the depths PERF.md reports (~24 min).
SSLP_15_45 = ["--module-name", "mpisppy_tpu_torch.models.sslp",
              "--n-servers", str(SSLP_SERVERS), "--n-clients",
              str(SSLP_CLIENTS), "--sslp-lp-relax", "--rel-gap", "0.01"]
LSHAPED_FLAGS = ["--lshaped-hub", "--xhatlshaped"]
# APH as the hub with sslp_options' rho, half the scenarios dispatched
# per iteration, the classic Lagrangian and x̂-x̄ spokes
APH_FLAGS = ["--default-rho", "20", "--aph-hub", "--aph-dispatch-frac",
             "0.5", "--lagrangian", "--xhatxbar"]
# bf16x3 (K2) as the headline, at PDHG tol 1e-5: bf16x3 solves certify
# there and stall short of 1e-6, where the classic x̂-x̄ spoke's
# evaluations never finish (no inner bound in 30 iterations at S=10,000);
# the JAX CLI takes the flags, and its CPU backend runs the products in
# f32
APH_BF16X3 = ["--iter-precision", "bf16x3", "--pdhg-tol", "1e-5"]
BOUND_SPOKE_FLAGS = ["--default-rho", "20", "--subgradient", "--lagranger",
                     "--ph-ob", "--reduced-costs", "--xhatxbar"]
# sslp 5x15 at S=100: the PH view grows rounds of 100 cut rows under 20
CROSS_SCEN = ["--module-name", "mpisppy_tpu_torch.models.sslp",
              "--n-servers", "5", "--n-clients", "15", "--num-scens", "100",
              "--sslp-lp-relax", "--rel-gap", "0.01", "--default-rho", "20",
              "--cross-scenario-cuts", "--lagrangian", "--xhatshuffle"]
# the L-shaped and APH batch sizes of the CLI runs, [slice9_windows] and
# the profile; the bound spokes run at LSHAPED_SCENS too
LSHAPED_SCENS = 1_000
APH_SCENS = 10_000
# the JAX CLI's (outer, inner) for [bound_spokes] at LSHAPED_SCENS, 1
# iteration (13 min on the CPU; at 2: -302.04495/-276.55063)
BOUND_SPOKES_JAX = (-303.463134765625, -276.5506286621094)


def sslp_cli(S, *flags):
    return SSLP_15_45 + ["--num-scens", str(S), *flags]


def slice9_table(full=False):
    """phase -> [(label, CLI args, the JAX CLI's (outer, inner) or
    None)] at the default run's depths, or with `full` at PERF.md's.  A
    None bound: the JAX CLI publishes none at that depth."""
    def d(short, long):
        return long if full else short
    return {
        # the subproblems detect infeasibility and may run 100,000 PDHG
        # iterations (2,500 windows) in each Benders iteration; the JAX
        # CLI's one at S=1,000 takes 3.5 min on the CPU and publishes no
        # inner bound, its 10 at S=100 take 3.4 min
        "lshaped_hub": [
            ("lshaped_hub", sslp_cli(LSHAPED_SCENS, *LSHAPED_FLAGS,
                                     "--lshaped-max-iter", d("1", "3"),
                                     "--kernel-counters"),
             d((-326.3166809082031, None), None)),
            *d([], [("lshaped_hub_100", sslp_cli(
                100, *LSHAPED_FLAGS, "--lshaped-max-iter", "10"),
                (-318.86767578125, -263.0153987079396))])],
        # the headline's size; the JAX CLI's 30 at S=100 in f32 take 9.7
        # min on the CPU; the S=100 run cut from 3 iterations to 2 (half
        # the scenarios are dispatched from the second on)
        "aph_hub": [
            ("aph_hub", sslp_cli(APH_SCENS, *APH_FLAGS,
                                 *d(APH_BF16X3, APH_BF16X3[:2]),
                                 "--max-iterations", d("2", "30")), None),
            ("aph_hub_100", sslp_cli(100, *APH_FLAGS, *d(APH_BF16X3, []),
                                     "--max-iterations", d("2", "30")),
             d((-317.7518310546875, -284.2300720214844),
               (-316.54156494140625, -284.23101806640625)))],
        "bound_spokes": [
            ("bound_spokes", sslp_cli(LSHAPED_SCENS, *BOUND_SPOKE_FLAGS,
                                      "--max-iterations", d("1", "10")),
             d(BOUND_SPOKES_JAX, None)),
            *d([], [("bound_spokes_100", sslp_cli(
                100, *BOUND_SPOKE_FLAGS, "--max-iterations", "10"),
                (-302.9385070800781, -284.1163024902344))])],
        # one iteration by default: the cuts generated after iter0 are
        # installed at the next sync, and the final EF check runs over
        # them
        "cross_scen": [("cross_scen", CROSS_SCEN + d(
            ["--cross-scenario-iter-cnt", "1", "--max-iterations", "1"],
            ["--max-iterations", "10"]),
            d((-103.318603515625, -86.65963745117188),
              (-96.95027923583984, -87.26406860351562)))],
    }


# [cli_ccopf_fused]: ccopf (3,3) --soc through --fused-wheel --xhatxbar,
# whose x̄ spoke is EFXhatInnerBound on a three-stage tree (the JAX CLI,
# same flags: 2 hub iterations)
CLI_CCOPF_FUSED = ["--module-name", "mpisppy_tpu_torch.models.ccopf",
                   "--branching-factors", "3", "3", "--soc", "--lagrangian",
                   "--xhatxbar", "--fused-wheel", "--max-iterations", "20"]
CLI_CCOPF_FUSED_JAX_BOUNDS = (71.77212524414062, 71.77219394929853)
# [sc]: the Schur-complement interior point on sslp 5x15 LP relaxation
# at S=100, in f64 on the card, against scipy HiGHS on algos/ef.py's EF
SC_SCENS = 100
SC_TOL = 1e-12
SC_REL_TOL = 1e-6
# the async exchange wheel: bench.py's bench_wheel_overhead_async (sslp
# 15x45, S=10,000, bf16x3, PH rho 20, 8 subproblem windows, tol 1e-6,
# restart 40; the four fused spokes, slam 2, shuffle 4, spoke_period 3)
ASYNC_OVERHEAD_ITERS = {False: 10, True: 30}     # by --full (cut from
                                                  # 12)
# the sync pair and staleness 1 are profiled over their last two hub
# iterations (the profiler slows the iterations after its window, so it
# goes last); the steady-state times of every run are read over
# iterations 4 to the one before that window (iter0 and the first two
# iterk left out, as bench.py), so all runs share one set
ASYNC_PROFILE_ITERS = 2
# the headline CLI flags at staleness 1, traced, capped at 10 hub
# iterations (cut from a 1% certificate, 80 iterations; --full: to 1%)
CLI_ASYNC_HEADLINE = CLI_HEADLINE + ["--async-staleness", "1"]
ASYNC_HEADLINE_ITERS = {False: 10, True: HEADLINE_MAX_ITERS}
# the README's sslp command on the fused wheel at staleness 1, and the
# JAX package's CLI on the CPU for the same command (python -m
# mpisppy_tpu --module-name mpisppy_tpu.models.sslp --num-scens 100
# --lagrangian --xhatshuffle --rel-gap 0.01 --fused-wheel
# --async-staleness 1 --max-iterations N): (outer, inner) by N; the
# port's must agree to 1e-3 relative
CLI_ASYNC_HELD = README_SSLP + ["--fused-wheel", "--async-staleness", "1"]
ASYNC_HELD_ITERS = {False: 10, True: 30}         # by --full
ASYNC_HELD_JAX_BOUNDS = {10: (-216.515869140625, -149.8999786376953),
                         30: (-215.45925903320312, -149.8999786376953)}
ASYNC_CCOPF_MAX_ITERS = 10
# checkpoints and preemption: the headline wheel saved in the background
# every CKPT_EVERY_S seconds (each save kept, up to CKPT_KEEP rotated
# files, so each can be re-read) and preempted at hub iteration
# CKPT_PREEMPT_AT by a fault plan; the README's sslp command through the
# CLI, run to PREEMPT_CLI_CAP PH iterations at most and sent SIGTERM
# once its trace shows hub iteration PREEMPT_CLI_AT, then resumed, like
# the uninterrupted run it is held to, for two more PH iterations
CKPT_EVERY_S = 5.0
CKPT_KEEP = 64
CKPT_PREEMPT_AT = 40
PREEMPT_CLI_AT = 3
PREEMPT_CLI_CAP = 10

def phase(name, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {parts}", flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    from mpisppy_tpu_torch.telemetry.profiler import card_info
    info = card_info()
    if info is None:
        raise RuntimeError("nvidia-smi gave no name and power limit")
    return info["nvidia_smi"]


def sslp_batch(S, n_servers, n_clients, device):
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import sslp
    inst = sslp.synthetic_instance(n_servers, n_clients, seed=0)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=S,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(S)]
    return batch_mod.from_specs(specs, device=device)


def ccopf_batch(bfs, device, n_buses=4):
    """The ccopf --soc batch on a feeder of n_buses (the CLI's default:
    4) over the (b1, b2) tree."""
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import ccopf
    inst = ccopf.feeder_instance(n_buses=n_buses)
    specs = [ccopf.scenario_creator(nm, instance=inst, branching_factors=bfs,
                                    soc=True)
             for nm in ccopf.scenario_names_creator(bfs[0] * bfs[1])]
    b = batch_mod.from_specs(specs, tree=ccopf.make_tree(bfs, inst),
                             device=device)
    if b.qp.cones is None:
        raise AssertionError("ccopf --soc batch lost its cone spec")
    return b


def window_inputs(batch, seed=0, done_every=7):
    """A mid-solve window input at the batch's shapes: two cold windows
    from init_state (through the kernel), per-scenario step sizes from
    the solver's omega/Lnorm, every `done_every`-th lane done (none for
    0)."""
    import dataclasses

    from mpisppy_tpu_torch.ops import pdhg
    opts = pdhg.PDHGOptions(restart_period=N_ITERS)
    st = pdhg.init_state(batch.qp, opts)
    st = pdhg.solve_fixed(batch.qp, 2, opts, st)
    g = torch.Generator(device="cpu").manual_seed(seed)
    omega = st.omega * (0.5 + torch.rand(st.omega.shape, generator=g)
                        .to(st.omega.device))
    st = dataclasses.replace(st, omega=omega)
    tau = opts.step_margin * st.omega / st.Lnorm
    sigma = opts.step_margin / (st.omega * st.Lnorm)
    done = torch.zeros_like(st.done)
    if done_every:
        done[::done_every] = True
    return (batch.qp, st.x, st.y, st.x_sum, st.y_sum, tau, sigma, done,
            N_ITERS)


def repeat_rows(t, reps):
    """t repeated `reps` times along the scenario axis."""
    return t.repeat((reps,) + (1,) * (t.ndim - 1)).contiguous()


def tiled_state(args, reps):
    """Only the solver state of window inputs (x, y, x_sum, y_sum, tau,
    sigma, done), repeated `reps` times along the scenario axis."""
    return tuple(repeat_rows(t, reps) for t in args[1:8])


def tiled(args, reps):
    """The same window inputs repeated `reps` times along the scenario
    axis (the S=100,000 sweep shape without building 100,000 specs)."""
    import dataclasses
    qp = args[0]
    qp = dataclasses.replace(qp, **{f: repeat_rows(getattr(qp, f), reps)
                                    for f in ("c", "q", "bl", "bu")})
    return (qp,) + tiled_state(args, reps) + (args[8],)


def max_err(kernel_out, plain_out, mode):
    """Max |k - r| over x, y, x_sum, y_sum, and whether every element
    passes |k - r| <= atol + rtol * |r|."""
    atol, rtol = TOLS[mode]
    worst, ok = 0.0, True
    for k, r in zip(kernel_out, plain_out):
        d = (k - r).abs()
        worst = max(worst, float(d.max()))
        ok = ok and bool(torch.all(d <= atol + rtol * r.abs()))
        ok = ok and bool(torch.isfinite(k).all())
    return worst, ok


def time_ms(fn, reps=5):
    """Mean device time per call (CUDA events around `reps` calls after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def card_peaks():
    """The card's peak rates (telemetry/roofline.py::CARD_PEAKS, keyed by
    the card's name); a card not in the table is bounded at the H100
    SXM's, and the [card] line says so."""
    from mpisppy_tpu_torch.telemetry import roofline
    return roofline.peaks_for(torch.cuda.get_device_name(0)) \
        or roofline.CARD_PEAKS[roofline.H100_SXM]


def window_bound_ms(args, mode, synth=None):
    """Least time one window could take on the card: the package's work
    model (ops/pdhg_window.py::window_work: bytes each read or written
    once, operations at the peak of their type) at the card's peaks."""
    from mpisppy_tpu_torch.ops import pdhg_window
    return pdhg_window.window_work(*args, precision=mode,
                                   synth=synth).bound_ms(card_peaks())


def sslp_options(iter_precision, max_iterations, tol, subproblem_windows):
    """bench_sslp_gap's PH options."""
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.ops import pdhg
    return ph_mod.PHOptions(
        default_rho=20.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=subproblem_windows,
        pdhg=pdhg.PDHGOptions(tol=tol, restart_period=N_ITERS,
                              iter_precision=iter_precision))


def ccopf_options(max_iterations=CCOPF_MAX_ITERS):
    """tests/test_cones.py's ccopf --soc options: rho 10, PDHG tol 1e-6,
    f32 iteration matvecs, capped at CCOPF_MAX_ITERS hub iterations."""
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.ops import pdhg
    return ph_mod.PHOptions(default_rho=10.0,
                            max_iterations=max_iterations, conv_thresh=0.0,
                            pdhg=pdhg.PDHGOptions(tol=1e-6))


def wheel_dicts(batch, opts, staleness=None, hub_extra=None):
    """(hub dict, spoke dicts) of the fused PH wheel (PH hub, fused
    Lagrangian and x̂-x̄ spokes) to a 1% gap, or of the async pair at
    `staleness`; `hub_extra` joins the hub's options."""
    from mpisppy_tpu_torch.algos import async_wheel as aw
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import AsyncPHHub, PHHub
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 0.01,
                                      **(hub_extra or {})}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions()}}
    if staleness is not None:
        hub["hub_class"], hub["opt_class"] = AsyncPHHub, aw.AsyncFusedPH
        hub["opt_kwargs"]["async_options"] = aw.AsyncWheelOptions(
            staleness=staleness)
    spokes = [{"spoke_class": spoke.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke.FusedXhatXbarInnerBound,
               "opt_kwargs": {"options": {}}}]
    return hub, spokes


def wheel(batch, opts, staleness=None):
    """The wheel of wheel_dicts spun; returns the spinner and its wall
    seconds."""
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    t0 = time.perf_counter()
    ws = WheelSpinner(*wheel_dicts(batch, opts, staleness)).spin()
    if batch.device.type == "cuda":
        torch.cuda.synchronize()
    return ws, time.perf_counter() - t0


def registers_by_instantiation(log):
    """ptxas's registers, spill bytes (stores+loads) and static shared
    memory of each kernel instantiation, from the build's -Xptxas -v
    output: streamed kernels keyed mode/scenarios-per-block/kind (box,
    cones or synth), resident ones mode/resident/kind, resident cone
    ones mode/resident_cones/scenarios-per-tile."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"pdhg_window_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
                      ln)
        r = re.search(r"pdhg_window_residentILi(\d+)ELb(\d)E", ln)
        c = re.search(r"pdhg_window_conesILi(\d+)ELi(\d+)E", ln)
        if "Compiling entry function" in ln and (m or r or c):
            if m:
                kind = "cones" if m[3] == "1" else "synth" if m[4] == "1" \
                    else "box"
                name = f"{MODE_NAMES[m[1]]}/{m[2]}/{kind}"
            elif r:
                kind = "synth" if r[2] == "1" else "box"
                name = f"{MODE_NAMES[r[1]]}/resident/{kind}"
            else:
                name = f"{MODE_NAMES[c[1]]}/resident_cones/{8 * int(c[2])}"
            spill = 0
        elif name and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes spill", ln)
            spill = sum(int(v) for v in nums)
        elif name and "Used " in ln and "registers" in ln:
            regs = int(ln.split("Used ")[1].split()[0])
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name] = f"{regs}r/{spill}s/{sm[1] if sm else 0}smem"
            name = None
    return ",".join(f"{k}:{v}" for k, v in sorted(out.items()))


def reset_launches():
    from mpisppy_tpu_torch.ops import pdhg_window
    for name in pdhg_window.run_window.launches:
        pdhg_window.run_window.launches[name] = 0
    pdhg_window.run_window.launches_by_design.clear()


STREAMED_SOURCE = "mpisppy_tpu_torch/csrc/pdhg_window.cu"
RESIDENT_SOURCE = "mpisppy_tpu_torch/csrc/pdhg_window_resident.cu"
CONES_SOURCE = "mpisppy_tpu_torch/csrc/pdhg_window_cones.cu"


def kernel_entry(name, source, replaces, launches, err, timing):
    ms, plain, bound, by = timing
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def parity(args, mode, label, S, synth=None, design=None, **extra):
    """Kernel against its plain version on the same inputs; done lanes
    must come back bit-unchanged.  `design` names the kernel's design
    (None: the shape rule's).  Returns (max_abs_err, kernel out)."""
    from mpisppy_tpu_torch.ops import pdhg_window
    k = pdhg_window.run_window(*args, precision=mode, synth=synth,
                               design=design)
    r = pdhg_window.run_window_reference(*args, precision=mode, synth=synth)
    torch.cuda.synchronize()
    err, ok = max_err(k, r, mode)
    done = args[7]
    frozen = torch.equal(k[0][done], args[1][done]) \
        and torch.equal(k[1][done], args[2][done])
    phase(label, S=S, mode=mode, n_iters=args[8],
          design=design or "rule", max_abs_err=err,
          tol=f"{TOLS[mode][0]}+{TOLS[mode][1]}*|plain|", ok=ok,
          done_lanes_unchanged=frozen, **extra)
    if not (ok and frozen):
        raise AssertionError(f"{label}: window kernel disagrees ({mode})")
    return err, k


def time_designs(a, label, designs, reps=5, **extra):
    """ms of one window in each design (timed in turns: d0 d1 d1 d0),
    its plain version's ms and the bound, in f32 and bf16x3.  Returns
    {(S, mode, design): (ms, plain, bound, by)}, ms the mean of the
    design's two turns."""
    from mpisppy_tpu_torch.ops import pdhg_window
    S = a[1].shape[0]
    out = {}
    for mode in ("f32", "bf16x3"):
        ms = {d: [] for d in designs}
        for d in list(designs) + list(reversed(designs)):
            ms[d].append(time_ms(lambda: pdhg_window.run_window(
                *a, precision=mode, design=d), reps=reps))
        plain = time_ms(lambda: pdhg_window.run_window_reference(
            *a, precision=mode), reps=2)
        bound, by = window_bound_ms(a, mode)
        for d in designs:
            out[S, mode, d] = (sum(ms[d]) / len(ms[d]), plain, bound, by)
        phase(label, S=S, mode=mode, n_iters=a[8],
              **{f"{d}_ms": "/".join(f"{v:.4f}" for v in ms[d])
                 for d in designs},
              plain_ms=round(plain, 3), bound_ms=round(bound, 4),
              bound_by=by, **extra)
    return out


def window_times(args, label, scens, designs, **extra):
    """time_designs at each S in `scens` (the larger ones tiled from
    `args`)."""
    S0 = args[1].shape[0]
    timing = {}
    for S in scens:
        a = args if S == S0 else tiled(args, S // S0)
        timing.update(time_designs(a, label, designs, **extra))
        del a
        torch.cuda.empty_cache()
    return timing


def mma_accumulation(qp, S=1024, seed=4):
    """The resident bf16x3 kernel's A'y against the exact sum of its
    three bf16 products: one iteration from x = 0 with tau = 1, c = q = 0
    and open bounds leaves x = -A'y as the kernel accumulated it.  The
    plain version's f32 matmuls are measured the same way.  Errors are
    relative to sum_i |A_ij| |y_i|, the scale of the rounding bound."""
    import dataclasses

    from mpisppy_tpu_torch.ops import pdhg_window
    g = torch.Generator(device="cpu").manual_seed(seed)
    m, n = qp.A.shape
    dev = qp.A.device
    y = torch.randn(S, m, generator=g).to(dev)
    zx, zy = torch.zeros(S, n, device=dev), torch.zeros(S, m, device=dev)
    big = torch.full((n,), 1e30, device=dev)
    p = dataclasses.replace(qp, c=zx, q=zx, l=-big, u=big,
                            bl=qp.bl[:1].expand(S, m),
                            bu=qp.bu[:1].expand(S, m))
    one = torch.ones(S, device=dev)
    args = (p, zx, y, zx, zy, one, one * 0, one < 0, 1)
    k = -pdhg_window.run_window(*args, precision="bf16x3",
                                design="resident")[0]
    r = -pdhg_window.run_window_reference(*args, precision="bf16x3")[0]
    yh, yl = pdhg_window._split_bf16(y)
    Ah, Al = pdhg_window._split_bf16(qp.A)
    exact = (yh.double() @ Ah.double() + yh.double() @ Al.double()
             + yl.double() @ Ah.double())
    scale = y.double().abs() @ qp.A.double().abs()
    scale = torch.clamp(scale, min=1e-30)
    kerr = float(((k.double() - exact).abs() / scale).max())
    perr = float(((r.double() - exact).abs() / scale).max())
    phase("mma_accumulation", S=S, m=m, n=n, resident_rel_err=kerr,
          plain_f32_rel_err=perr, f32_eps=torch.finfo(torch.float32).eps)
    return kerr


def small_wheel(label, model, gpu_batch, cpu_batch, opts, **extra):
    """The same wheel on the card and on the CPU: both certify 1% and
    their bounds agree to 1e-3 relative.  Returns the card's spinner."""
    g, g_s = wheel(gpu_batch, opts)
    c, c_s = wheel(cpu_batch, opts)
    g_gap = g.spcomm.compute_gaps()[1]
    c_gap = c.spcomm.compute_gaps()[1]
    rel = [abs(a - b) / abs(b) for a, b in
           ((g.BestOuterBound, c.BestOuterBound),
            (g.BestInnerBound, c.BestInnerBound))]
    phase(label, S=gpu_batch.num_scenarios, model=model,
          gpu_iters=g.spcomm._iter, cpu_iters=c.spcomm._iter,
          outer=g.BestOuterBound, inner=g.BestInnerBound, rel_gap=g_gap,
          cpu_outer=c.BestOuterBound, cpu_inner=c.BestInnerBound,
          cpu_rel_gap=c_gap, max_rel_diff=max(rel), gpu_s=round(g_s, 2),
          cpu_s=round(c_s, 2), **extra)
    if not (g_gap <= 0.01 and c_gap <= 0.01 and max(rel) <= 1e-3):
        raise AssertionError(f"{label}: no 1% certificate on the card or "
                             "the CPU, or their bounds disagree")
    return g


def main_wheel(label, kernel, batch, opts, slack=0.0, staleness=None,
               **fields):
    """Drive one main path with the launch counts set to 0 just before
    and read just after; its kernel must have launched, and its bounds
    be finite and ordered (outer <= inner + slack * max(1, |inner|)).
    Returns the spinner, the launches by instantiation and the launches
    by instantiation/mode/design."""
    from mpisppy_tpu_torch.ops import pdhg_window
    reset_launches()
    ws, secs = wheel(batch, opts, staleness)
    launches = dict(pdhg_window.run_window.launches)
    by_design = dict(pdhg_window.run_window.launches_by_design)
    outer, inner = ws.BestOuterBound, ws.BestInnerBound
    rel_gap = ws.spcomm.compute_gaps()[1]
    iters = ws.spcomm._iter
    phase(label, S=batch.num_scenarios, **fields, iterations=iters,
          outer=outer, inner=inner, rel_gap=rel_gap,
          certified=rel_gap <= 0.01, seconds=round(secs, 2),
          kernel_launches=launches[kernel],
          launches_per_hub_iter=round(launches[kernel] / max(1, iters), 2),
          all_launches=json.dumps(launches).replace(" ", ""),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (launches[kernel] > 0 and math.isfinite(outer)
            and math.isfinite(inner)
            and outer <= inner + slack * max(1.0, abs(inner))):
        raise AssertionError(f"{label}: no {kernel} launches, or bounds "
                             "not finite and ordered")
    return ws, launches, by_design


def check_designs(label, by_design, m, n, scens):
    """Every box window of a sslp wheel took the design the shape rule
    gives its mode at one of the wheel's batch sizes (`scens`: the batch
    and its straggler tail), and both f32 and bf16x3 ran resident."""
    from mpisppy_tpu_torch.ops import pdhg_window
    limits = pdhg_window.card_limits(torch.cuda.current_device())
    for key, count in by_design.items():
        kernel, mode, design = key.split("/")
        allowed = {pdhg_window.plan_window(mode, m, n, S, *limits).design
                   for S in scens}
        if kernel == "pdhg_window" and design not in allowed:
            raise AssertionError(f"{label}: {count} {key} launches, the "
                                 f"shape rule gives {sorted(allowed)}")
    resident = {mode: by_design.get(f"pdhg_window/{mode}/resident", 0)
                for mode in ("f32", "bf16x3")}
    phase(label, resident_f32=resident["f32"],
          resident_bf16x3=resident["bf16x3"], rule_followed=True)
    if min(resident.values()) <= 0:
        raise AssertionError(f"{label}: no resident launches in f32 or "
                             "bf16x3")


_KERNEL_NAME = re.compile(r"pdhg_window_(kernel|resident|cones)<(\d+)")


def window_kernel_key(name):
    """mode/design of a window kernel from its demangled name
    (pdhg_window_kernel<MODE, ...> is the streamed body,
    pdhg_window_resident<MODE, ...> and pdhg_window_cones<MODE, ...> the
    resident ones), else None."""
    m = _KERNEL_NAME.search(name)
    if m is None:
        return None
    design = "streamed" if m[1] == "kernel" else "resident"
    return f"{MODE_NAMES[m[2]]}/{design}"


def headline_profile(dev, batch=None):
    """profile_wheel over a capped run of the headline (PROFILE_HUB_ITERS
    hub iterations), its busy share also read back from the exported
    trace."""
    if batch is None:
        batch = sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    profile_wheel("headline_profile", batch, lambda: wheel(
        batch, sslp_options("bf16x3", PROFILE_HUB_ITERS, 1e-6, 8)),
        readback=True)


def ccopf_profile(dev, batch=None):
    """profile_wheel over a capped run of the ccopf (100,100) wheel
    (CCOPF_PROFILE_HUB_ITERS hub iterations)."""
    if batch is None:
        batch = ccopf_batch(CCOPF_BFS, dev)
    profile_wheel("ccopf_profile", batch, lambda: wheel(
        batch, ccopf_options(CCOPF_PROFILE_HUB_ITERS)))


def recorded_events(prof):
    """(name, on_device, start_us, end_us) of every event a finished
    torch.profiler recorded, read from its kineto results: building the
    profiler's FunctionEvent list (prof.events()) costs ~75 us an event,
    which over a profiled wheel's 10^4-10^5 events was most of a profile
    phase's time."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def device_spans(prof):
    """(start_us, end_us) of every device activity (kernels, memsets,
    copies) a profiler recorded, as the package reads its kineto result
    (telemetry/deviceprof.py::timeline_from_profiler)."""
    from mpisppy_tpu_torch.telemetry import deviceprof
    tl = deviceprof.timeline_from_profiler(prof)
    return [(o.start_us, o.end_us) for o in tl.ops] \
        + [(d.start_us, d.end_us) for d in tl.dma]


def busy_us(spans):
    """Length of the union of (start, end) spans (the package's
    roofline._union)."""
    from mpisppy_tpu_torch.telemetry import roofline
    return roofline._union(spans)[0]


def profile_wheel(label, batch, run, readback=False):
    """torch.profiler over one wheel run (run() returns the spinner and
    its wall seconds), read through the package (telemetry/deviceprof.py,
    roofline.py): the device busy share of the capture (its device
    activity over its wall span), read from the live profile and again
    from its exported file — the two must agree within 0.01 — the busy
    time over the run's wall, the window kernel's share of device time
    by mode and design, and the top five other kernels.  The same run
    without the profiler goes first (it also warms up); its wall time
    shows what the profiler adds on the host.  Only device activity is
    traced.  A profile without device activity fails the phase: there is
    no fallback to other timers.  Only with `readback` is the profile
    exported and read again (a ~200 MB trace for the headline's)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from mpisppy_tpu_torch.telemetry import deviceprof, roofline
    _, plain_secs = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ws, secs = run()
    tl = deviceprof.timeline_from_profiler(prof)
    share = file_share = roofline.busy_share(tl)
    back = {}
    if readback:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, f"{label}.pt.trace.json")
            t0 = time.perf_counter()
            prof.export_chrome_trace(path)
            export_s = time.perf_counter() - t0
            trace_bytes = os.path.getsize(path)
            t0 = time.perf_counter()
            file_share = roofline.busy_share(
                deviceprof.build_timeline(path))
            back = dict(file_busy_share=None if file_share is None
                        else round(file_share, 4),
                        export_s=round(export_s, 3),
                        trace_bytes=trace_bytes,
                        read_s=round(time.perf_counter() - t0, 3))
    del prof
    if not tl.ops or share is None or file_share is None:
        raise AssertionError(f"{label}: the profile holds no device "
                             "activity")
    spans, by_kernel = [], {}
    for name, a, b in [(o.name, o.start_us, o.end_us) for o in tl.ops] \
            + [(c.name, c.start_us, c.end_us) for c in tl.dma]:
        spans.append((a, b))
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a)
    device_us = sum(by_kernel.values())
    window, other = {}, {}
    for name, us in by_kernel.items():
        key = window_kernel_key(name)
        if key is None:
            other[name] = us
        else:
            window[key] = window.get(key, 0.0) + us
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    shares = {k: v / device_us for k, v in window.items()}
    phase(label, S=batch.num_scenarios,
          hub_iters=ws.spcomm._iter, wall_s=round(secs, 3),
          wall_unprofiled_s=round(plain_secs, 3),
          device_ms=round(device_us / 1e3, 3),
          device_busy_share=round(share, 4), **back,
          busy_over_run_wall=round(busy_us(spans) / (secs * 1e6), 4),
          window_share=json.dumps({k: round(v, 4) for k, v in
                                   sorted(shares.items())}).replace(" ", ""),
          window_ms=json.dumps({k: round(v / 1e3, 3) for k, v in
                                sorted(window.items())}).replace(" ", ""))
    for name, us in top:
        phase(label, other_kernel=f"'{name[:90]}'",
              ms=round(us / 1e3, 3), share=round(us / device_us, 4))
    if abs(share - file_share) > 0.01:
        raise AssertionError(f"{label}: the busy share of the live profile "
                             f"({share}) and of its exported file "
                             f"({file_share}) disagree")


def sslp_path(dev, sync):
    """The sslp phases: the resident kernel against its plain version at
    S=10,000 and at the straggler tail's shape, the streamed body at
    S=10,000, the tensor-core accumulation error, window times of both
    designs, the S=64 wheel on card and CPU, the profile of a capped
    headline run, and the sslp 15x45 headline at S=10,000 (its batch
    and trace go into `sync` for [checkpoint_headline])."""
    batch = sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    args = window_inputs(batch)
    tail = sslp_batch(TAIL_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    tail_args = window_inputs(tail, seed=1)[:8] + (TAIL_ITERS,)
    del tail
    errs, streamed_errs = {}, {}
    for mode in ("f32", "bf16x3"):
        errs[mode] = parity(args, mode, "parity", HEADLINE_SCENS,
                            design="resident")[0]
        parity(tail_args, mode, "parity", TAIL_SCENS, design="resident")
        streamed_errs[mode] = parity(args, mode, "parity", HEADLINE_SCENS,
                                     design="streamed")[0]
    mma_accumulation(batch.qp)
    timing = window_times(args, "window_time", SWEEP_SCENS, DESIGNS)
    timing.update(time_designs(tail_args, "window_time", DESIGNS, reps=20,
                               shape="tail"))

    small_wheel("wheel_small", "sslp_5_15", sslp_batch(64, 5, 15, dev),
                sslp_batch(64, 5, 15, "cpu"),
                sslp_options(None, 200, 1e-7, 10))

    headline_profile(dev, batch)
    by_design = headline(batch, sync)
    return [kernel_entry(name, RESIDENT_SOURCE,
                         f"mpisppy_tpu/ops/pdhg_pallas.py:{line}",
                         by_design[f"pdhg_window/{mode}/resident"],
                         errs[mode], timing[HEADLINE_SCENS, mode, "resident"])
            for name, mode, line in (("pdhg_window", "bf16x3", 663),
                                     ("pdhg_window_f32", "f32", 491))] + [
        # the streamed box design (batches past the resident rows: the
        # L-shaped master, the cross-scenario PH view), timed in f32
        kernel_entry("pdhg_window_streamed", STREAMED_SOURCE,
                     "mpisppy_tpu/ops/pdhg_pallas.py:491",
                     sum(v for k, v in by_design.items()
                         if k.startswith("pdhg_window/")
                         and k.endswith("/streamed")),
                     streamed_errs["f32"],
                     timing[HEADLINE_SCENS, "f32", "streamed"])]


def headline(batch, sync):
    """[headline]: sslp 15x45, 10,000 scenarios, bench_sslp_gap's
    options, through the kernels the shape rule picks; its batch, trace
    rows and bounds go into `sync`.  Returns the launches by design."""
    ws, _, by_design = main_wheel(
        "headline", "pdhg_window", batch,
        sslp_options("bf16x3", HEADLINE_MAX_ITERS, 1e-6, 8),
        model="sslp_15_45", iter_precision="bf16x3")
    check_designs("headline", by_design, batch.qp.m, batch.qp.n,
                  (HEADLINE_SCENS, TAIL_SCENS))
    sync["headline"] = {"batch": batch, "rows": trace_rows(ws),
                        "bounds": (ws.BestOuterBound, ws.BestInnerBound),
                        "iterations": ws.spcomm._iter}
    return by_design


def trace_rows(ws):
    """The hub's trace rows, `t` made relative to the hub's start."""
    return [{**r, "t": r["t"] - ws.spcomm._t0} for r in ws.spcomm.trace]


def soc_parity(args, mode, S, qp, design=None, **extra):
    """parity() of a SOC window with its live duals in the polar cone
    (frozen lanes keep the solver's polar-cone duals, so every lane is
    checked).  Returns max_abs_err."""
    from mpisppy_tpu_torch.ops import cones
    err, k = parity(args, mode, "parity_soc", S, design=design, **extra)
    dcr = float(cones.dual_cone_residual_rows(qp.cones, k[1]).max())
    phase("parity_soc", S=S, mode=mode, n_iters=args[8],
          design=design or "rule", polar_cone_residual=dcr, tol=POLAR_TOL)
    if not dcr <= POLAR_TOL:
        raise AssertionError("SOC kernel: duals left the polar cone")
    return err


def check_soc_designs(label, by_design):
    """Every SOC window of the ccopf wheel took the resident design (the
    shape rule's at every batch size of the wheel), and f32 ran."""
    streamed = {k: v for k, v in by_design.items()
                if k.startswith("pdhg_window_soc/") and k.endswith("/streamed")}
    resident = by_design.get("pdhg_window_soc/f32/resident", 0)
    phase(label, soc_resident_f32=resident,
          soc_streamed=json.dumps(streamed).replace(" ", ""))
    if streamed or resident <= 0:
        raise AssertionError(f"{label}: SOC windows on the streamed design, "
                             "or no f32 resident SOC window")


def ccopf_path(dev, sync):
    """The ccopf --soc phases: SOC-window parity (ccopf at S=10,000 and
    the 64 x 160 tail in the shape rule's design, the 33-bus feeder on
    the streamed design), window times of both designs, the (3,3) wheel
    on card and CPU, the profile of a capped (100,100) wheel, and the
    (100,100) wheel at S=10,000, whose bounds go into `sync` for
    [async_ccopf]."""
    from mpisppy_tpu_torch.ops import pdhg_window
    S = CCOPF_BFS[0] * CCOPF_BFS[1]
    t0 = time.perf_counter()
    batch = ccopf_batch(CCOPF_BFS, dev)
    phase("ccopf_build", S=S, n=batch.qp.n, m=batch.qp.m,
          soc_blocks=batch.qp.cones.num_cones,
          soc_rows=int(batch.qp.cones.is_soc.sum()),
          tree_nodes=batch.tree.num_nodes,
          seconds=round(time.perf_counter() - t0, 2))
    args = window_inputs(batch)
    # the fused wheel's straggler tail: 64 scenarios, 160 iterations
    tail = ccopf_batch((8, 8), dev)
    tail_args = window_inputs(tail, seed=1)[:8] + (TAIL_ITERS,)
    limits = pdhg_window.card_limits(torch.cuda.current_device())
    _, rows = batch.qp.cones.csr(dev)
    cone_ints = batch.qp.cones.num_cones + 1 + rows.numel() + batch.qp.m
    plans = {s_: pdhg_window.plan_window("f32", batch.qp.m, batch.qp.n, s_,
                                         *limits, cone_ints=cone_ints)
             for s_ in (S, TAIL_SCENS)}
    phase("ccopf_plan", **{f"S{k}": f"{v.design}/T{v.tile}/blocks{v.blocks}"
                           for k, v in plans.items()})
    errs, streamed_errs = {}, {}
    for mode in ("f32", "bf16x3"):
        errs[mode] = soc_parity(args, mode, S, batch.qp, model="ccopf_soc")
        soc_parity(tail_args, mode, TAIL_SCENS, tail.qp, model="ccopf_soc")
        streamed_errs[mode] = soc_parity(args, mode, S, batch.qp,
                                         design="streamed",
                                         model="ccopf_soc")
    wide = ccopf_batch((WIDE_SCENS, 1), dev, n_buses=WIDE_FEEDER_BUSES)
    soc_parity(window_inputs(wide, seed=2), "f32", WIDE_SCENS, wide.qp,
               design="streamed", model=f"ccopf_soc_{WIDE_FEEDER_BUSES}bus",
               n=wide.qp.n, m=wide.qp.m, soc_blocks=wide.qp.cones.num_cones)
    del wide
    timing = window_times(args, "window_time_soc", SWEEP_SCENS, DESIGNS,
                          model="ccopf_soc")
    timing.update(time_designs(tail_args, "window_time_soc", DESIGNS,
                               reps=20, model="ccopf_soc", shape="tail"))
    del tail, tail_args

    small_wheel("wheel_soc_small", "ccopf_soc_3x3",
                ccopf_batch(CCOPF_SMALL_BFS, dev),
                ccopf_batch(CCOPF_SMALL_BFS, "cpu"), ccopf_options())

    ccopf_profile(dev, batch)
    ws, _, by_design = main_wheel(
        "ccopf_soc", "pdhg_window_soc", batch, ccopf_options(),
        slack=HUB_BOUND_SLACK, model="ccopf_soc",
        bfs="x".join(map(str, CCOPF_BFS)), iter_precision="f32")
    check_soc_designs("ccopf_soc", by_design)
    sync["ccopf_soc"] = (ws.BestOuterBound, ws.BestInnerBound)
    nodes = ws.spcomm.best_nonants().shape[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        (ws.BestOuterBound, ws.BestInnerBound), CCOPF_JAX_BOUNDS))
    phase("ccopf_soc", best_nonants_rows=nodes,
          jax_outer=CCOPF_JAX_BOUNDS[0], jax_inner=CCOPF_JAX_BOUNDS[1],
          max_rel_diff_vs_jax=rel)
    if nodes != batch.tree.num_nodes or rel > 1e-3:
        raise AssertionError("ccopf_soc: not one best_nonants row per tree "
                             "node, or bounds off the JAX reference")
    return [kernel_entry("pdhg_window_soc", CONES_SOURCE,
                         "mpisppy_tpu/ops/pdhg_pallas.py:192",
                         by_design["pdhg_window_soc/f32/resident"],
                         errs["f32"], timing[S, "f32", "resident"]),
            # the streamed SOC design (conic batches no resident tile
            # takes: the 33-bus feeder, the root-fixed ccopf EF)
            kernel_entry("pdhg_window_soc_streamed", STREAMED_SOURCE,
                         "mpisppy_tpu/ops/pdhg_pallas.py:192",
                         sum(v for k, v in by_design.items()
                             if k.startswith("pdhg_window_soc/")
                             and k.endswith("/streamed")),
                         streamed_errs["f32"], timing[S, "f32", "streamed"])]


def counting_plain_windows(fn):
    """Run fn() counting the restart windows that took the plain batched
    iteration (pdhg.window_engine == "plain").  Returns (fn's result,
    the count)."""
    from mpisppy_tpu_torch.ops import pdhg
    real, count = pdhg._window, [0]

    def counted(p, st, opts):
        if pdhg.window_engine(p, st.x.device.type) == "plain":
            count[0] += 1
        return real(p, st, opts)
    pdhg._window = counted
    try:
        return fn(), count[0]
    finally:
        pdhg._window = real


def farmer_wheel(batch, rel_gap, max_iterations=FARMER_MAX_ITERS):
    """tests/test_fused_wheel.py's farmer wheel: the PH hub with all four
    fused spokes (Lagrangian, x̂-x̄, shuffle, slam to the scenario min),
    rho 1, PDHG tol 1e-7.  Returns the spinner, its wall seconds and its
    plain-iteration windows."""
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=max_iterations,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg.PDHGOptions(tol=1e-7))
    wopts = fw.FusedWheelOptions(
        slam_windows=2, shuffle_windows=4, slam_sense_max=False,
        lag_pdhg=pdhg.PDHGOptions(tol=1e-7),
        xhat_pdhg=pdhg.PDHGOptions(tol=1e-7, omega0=0.1, restart_period=80))
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": rel_gap}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": wopts}}
    spokes = [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        spoke.FusedLagrangianOuterBound, spoke.FusedXhatXbarInnerBound,
        spoke.FusedXhatShuffleInnerBound, spoke.FusedSlamHeuristic)]

    def run():
        t0 = time.perf_counter()
        ws = WheelSpinner(hub, spokes).spin()
        if batch.device.type == "cuda":
            torch.cuda.synchronize()
        return ws, time.perf_counter() - t0
    (ws, secs), plain = counting_plain_windows(run)
    return ws, secs, plain


def farmer_program_batch(dev):
    """The farmer scengen program (seed 0) as a VirtualBatch at
    FARMER_SCENS scenarios: yields drawn at every step entry."""
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.models import farmer
    return scengen.virtual_batch(
        farmer.scenario_program(FARMER_SCENS, seed=0), device=dev)


def farmer_profile(dev):
    """profile_wheel over a capped run of the farmer program's wheel
    (FARMER_PROFILE_HUB_ITERS hub iterations).  Not in the default run:
    the profiler's event list of its ~10^5 small launches takes minutes
    to read back."""
    vb = farmer_program_batch(dev)
    profile_wheel("farmer_profile", vb, lambda: farmer_wheel(
        vb, 0.01, FARMER_PROFILE_HUB_ITERS)[:2])


def check_no_kernel(label):
    """A per-scenario-A path launches no window kernel, by rule."""
    from mpisppy_tpu_torch.ops import pdhg_window
    launches = sum(pdhg_window.run_window.launches.values())
    if launches:
        raise AssertionError(f"{label}: {launches} window-kernel launches "
                             "on a per-scenario-A batch")


def farmer_path(dev):
    """The farmer phases: the four-spoke fused wheel at S=3 on the card
    and on the CPU (bounds agree to 1e-3, inner within 5e-3 of the EF
    value), then the farmer scengen program's VirtualBatch wheel at
    S=10,000 on the card to a 1% certificate.  Every window runs the
    plain batched iteration; the window kernel must not launch."""
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import farmer
    specs = [farmer.scenario_creator(nm, num_scens=FARMER_SMALL_SCENS)
             for nm in farmer.scenario_names_creator(FARMER_SMALL_SCENS)]
    reset_launches()
    g, g_s, g_plain = farmer_wheel(batch_mod.from_specs(specs, device=dev),
                                   5e-3)
    check_no_kernel("farmer_wheel")
    c, c_s, _ = farmer_wheel(batch_mod.from_specs(specs, device="cpu"), 5e-3)
    rel = max(abs(a - b) / abs(b) for a, b in (
        (g.BestOuterBound, c.BestOuterBound),
        (g.BestInnerBound, c.BestInnerBound)))
    inner_vs_ef = abs(g.BestInnerBound - FARMER_EF_OBJ) / abs(FARMER_EF_OBJ)
    phase("farmer_wheel", S=FARMER_SMALL_SCENS, model="farmer",
          hub_iters=g.spcomm._iter, cpu_hub_iters=c.spcomm._iter,
          outer=g.BestOuterBound, inner=g.BestInnerBound,
          rel_gap=g.spcomm.compute_gaps()[1], cpu_outer=c.BestOuterBound,
          cpu_inner=c.BestInnerBound, max_rel_diff=rel,
          inner_vs_ef=inner_vs_ef, wall_s=round(g_s, 3),
          cpu_wall_s=round(c_s, 3), plain_windows=g_plain,
          plain_windows_per_hub_iter=round(g_plain / g.spcomm._iter, 2),
          kernel_launches=0)
    if not (rel <= 1e-3 and inner_vs_ef <= 5e-3
            and g.spcomm.compute_gaps()[1] <= 5e-3):
        raise AssertionError("farmer_wheel: card and CPU bounds disagree, "
                             "or no 0.5% certificate near the EF value")

    vb = farmer_program_batch(dev)
    reset_launches()
    ws, secs, plain = farmer_wheel(vb, 0.01)
    check_no_kernel("farmer_wheel")
    outer, inner = ws.BestOuterBound, ws.BestInnerBound
    rel_gap = ws.spcomm.compute_gaps()[1]
    phase("farmer_wheel", S=FARMER_SCENS, model="farmer_scengen",
          hub_iters=ws.spcomm._iter, outer=outer, inner=inner,
          rel_gap=rel_gap, certified=rel_gap <= 0.01, wall_s=round(secs, 3),
          s_per_hub_iter=round(secs / ws.spcomm._iter, 4),
          plain_windows=plain,
          plain_windows_per_hub_iter=round(plain / ws.spcomm._iter, 2),
          kernel_launches=0)
    if not (math.isfinite(outer) and math.isfinite(inner)
            and outer <= inner and rel_gap <= 0.01):
        raise AssertionError("farmer_wheel: no 1% certificate at S=10,000")


def cli_run(label, args, box_kernel=True, kernel="pdhg_window"):
    """generic_cylinders.main(args) in this process, on the card, with
    the launch counts set to 0 just before and read just after: the
    window kernel `kernel` (the box rows' by default) must have launched
    (box_kernel), or no window kernel at all (an ELL batch).  The CLI's own JSON result line is captured and
    printed as fields of this phase's line.  Returns (its JSON result,
    launches by instantiation, launches by design, the spinner)."""
    import contextlib
    import io

    from mpisppy_tpu_torch import generic_cylinders
    from mpisppy_tpu_torch.ops import pdhg_window
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ws = generic_cylinders.main(list(args))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(pdhg_window.run_window.launches)
    by_design = dict(pdhg_window.run_window.launches_by_design)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    result["wall_s"] = secs
    phase(label, S=ws.opt.batch.num_scenarios,
          device=ws.opt.batch.device.type, hub_iters=result["iterations"],
          outer=result["outer_bound"], inner=result["inner_bound"],
          rel_gap=result["rel_gap"], wall_s=round(secs, 3),
          kernel_launches=launches[kernel],
          all_launches=json.dumps(launches).replace(" ", ""),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    outer, inner = result["outer_bound"], result["inner_bound"]
    launched = launches[kernel] > 0 if box_kernel \
        else sum(launches.values()) == 0
    # a short run may end before an inner bound lands (null in the JSON)
    if ws.opt.batch.device.type != "cuda" or outer is None \
            or (inner is not None and outer > inner) or not launched:
        raise AssertionError(f"{label}: not on the card, no outer bound, "
                             "bounds crossed, or the window kernel "
                             "launched against its route")
    return result, launches, by_design, ws


def vs_jax(label, result, jax_bounds, rtol):
    """The CLI result's bounds against the JAX CLI's for the command (a
    None in `jax_bounds`: the JAX CLI published no such bound, and that
    one is not held)."""
    pairs = [(result[k], j) for k, j in zip(("outer_bound", "inner_bound"),
                                            jax_bounds) if j is not None]
    if any(r is None for r, _ in pairs):
        raise AssertionError(f"{label}: a bound is missing")
    rel = max(abs(r - j) / abs(j) for r, j in pairs)
    phase(label, jax_outer=jax_bounds[0], jax_inner=jax_bounds[1],
          max_rel_diff_vs_jax=rel, tol=rtol)
    if rel > rtol:
        raise AssertionError(f"{label}: bounds off the JAX reference")


def cli_path(sync):
    """The CLI phases: the README's sslp command (classic Lagrangian and
    shuffle spokes, S=100, sslp 5x25 with integer first stage) without
    --presolve (cut to 2 hub iterations) and with it (also cut to 2), each
    against the JAX
    package's bounds for the same command, and the box kernel against
    its plain version on the presolved batch (per-scenario l/u); the
    sslp 15x45 headline at S=10,000 through the CLI with all four
    fusable spokes in bf16x3 for CLI_HEADLINE_ITERS hub iterations, every
    box window in the design the shape rule gives (its result goes into
    `sync` for [async_headline]); the uc model with --fwph for 1 hub
    iteration (ELL: no window kernel)."""
    result, _, _, _ = cli_run("cli_readme", CLI_README)
    vs_jax("cli_readme", result, CLI_README_JAX_BOUNDS, 1e-3)
    result, _, _, ws = cli_run("cli_readme_presolve", CLI_README_PRESOLVE)
    vs_jax("cli_readme_presolve", result, CLI_README_PRESOLVE_JAX_BOUNDS,
           1e-4)
    pre = ws.opt.batch
    if pre.qp.l.ndim != 2 or pre.qp.u.ndim != 2:
        raise AssertionError("cli_readme_presolve: FBBT left the box shared")
    args = window_inputs(pre)
    for mode in ("f32", "bf16x3"):
        parity(args, mode, "parity_presolved", pre.num_scenarios,
               bounds="per_scenario_l_u")
    del ws, pre, args
    result, _, by_design, ws = cli_run("cli_headline", cli_capped(
        CLI_HEADLINE, "--max-iterations", CLI_HEADLINE_ITERS))
    sync["cli_headline"] = result
    qp = ws.opt.batch.qp
    check_designs("cli_headline", by_design, qp.m, qp.n,
                  (HEADLINE_SCENS, TAIL_SCENS))
    del ws, qp
    torch.cuda.empty_cache()
    _, _, _, ws = cli_run("cli_uc", CLI_UC, box_kernel=False)
    names = [type(sp).__name__ for sp in ws.spcomm.spokes]
    phase("cli_uc", spokes=",".join(names))
    if "FWPHOuterBound" not in names:
        raise AssertionError("cli_uc: --fwph built no FWPH spoke")


def ulps(a, b):
    """Largest distance between two f32 tensors in units in the last
    place."""
    def ordered(v):
        i = v.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def normal_path(dev):
    """The power iteration's start vector and its norm estimate: the
    XLA-exact normal (PRNGKey(7), and per-scenario scen_key draws as the
    uc sampler's) on the card against the CPU, and the farmer S=3 norm
    estimate on the card against the CPU's and the JAX package's."""
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.scengen import random as rnd
    from mpisppy_tpu_torch.scengen.program import scen_key
    draws = {}
    for name, key, shape in (
            ("key7", lambda d: rnd.prng_key(7, d), (NORMAL_DRAWS,)),
            ("scen_key", lambda d: scen_key(
                rnd.prng_key(0, d), torch.arange(40_000, device=d)), (25,))):
        cpu = rnd.normal(key("cpu"), shape)
        card = rnd.normal(key(dev), shape)
        torch.cuda.synchronize()
        draws[name] = ulps(card.cpu(), cpu)
    specs = [farmer.scenario_creator(nm, num_scens=3)
             for nm in farmer.scenario_names_creator(3)]
    card = pdhg.estimate_norm(batch_mod.from_specs(specs, device=dev).qp)
    cpu = pdhg.estimate_norm(batch_mod.from_specs(specs, device="cpu").qp)
    jax_norm = torch.tensor(FARMER_JAX_NORM)
    vs_cpu = float(((card.cpu() - cpu).abs() / cpu).max())
    vs_jax_rel = float(((card.cpu() - jax_norm).abs() / jax_norm).max())
    phase("normal", draws=NORMAL_DRAWS,
          max_ulp_card_vs_cpu=json.dumps(draws).replace(" ", ""),
          farmer_norm=json.dumps([round(float(v), 7) for v in card]),
          norm_rel_vs_cpu=vs_cpu, norm_rel_vs_jax=vs_jax_rel, tol=1e-5)
    if max(draws.values()) > 2 or vs_jax_rel > 1e-5 or vs_cpu > 1e-5:
        raise AssertionError("normal: the card's draws or norm estimate "
                             "off the CPU's or the JAX package's")


def uc_batch(S, device):
    """bench.py's uc instance (seed 0) at S scenarios: one shared ELL A."""
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import uc
    inst = uc.synthetic_instance(UC_GENS, UC_HOURS, seed=0)
    specs = [uc.scenario_creator(nm, instance=inst, num_scens=S)
             for nm in uc.scenario_names_creator(S)]
    return batch_mod.from_specs(specs, device=device)


def uc_wheel(batch, max_iterations):
    """bench.py's bench_uc_fwph wheel: PH hub (rho 1 with
    SepRho(multiplier=2), 10 subproblem windows, tol 1e-6, restart period
    40, bf16x3 iteration precision: ignored by the ELL products), the
    FWPH spoke (rho 200, its PDHG at tol 1e-6 and 4,000 iterations), the
    fused Lagrangian, x̂-x̄ and slam planes (slam_windows 2) and
    spoke_sync_period 5.  Returns the spinner, its wall seconds and its
    plain-iteration windows."""
    import functools

    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.extensions.rho_setters import SepRho
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=10,
        pdhg=pdhg.PDHGOptions(tol=1e-6, restart_period=N_ITERS,
                              iter_precision="bf16x3"))
    spoke_pdhg = pdhg.PDHGOptions(tol=1e-6, max_iters=4_000)
    spokes = [{"spoke_class": spoke.FWPHOuterBound,
               "opt_kwargs": {"options": {"rho": 200.0,
                                          "pdhg_opts": spoke_pdhg}}}]
    spokes += [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        spoke.FusedLagrangianOuterBound, spoke.FusedXhatXbarInnerBound,
        spoke.FusedSlamHeuristic)]
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 0.01,
                                      "spoke_sync_period": 5}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions(
                              slam_windows=2),
                          "extensions": functools.partial(
                              SepRho, multiplier=2.0)}}

    def run():
        t0 = time.perf_counter()
        ws = WheelSpinner(hub, spokes).spin()
        torch.cuda.synchronize()
        return ws, time.perf_counter() - t0
    (ws, secs), plain = counting_plain_windows(run)
    return ws, secs, plain


def uc_wheel_phase(label, batch, max_iterations, model="uc_10g24h",
                   jax_outer=None):
    """uc_wheel with the launch counts set to 0 just before and read just
    after (an ELL batch launches no window kernel); its outer bound must
    be finite, below any inner bound and, given `jax_outer`, within 1e-3
    of the JAX package's."""
    reset_launches()
    ws, secs, plain = uc_wheel(batch, max_iterations)
    check_no_kernel(label)
    iters = ws.spcomm._iter
    outer, inner = ws.BestOuterBound, ws.BestInnerBound
    fwph = [sp for sp in ws.spcomm.spokes
            if type(sp).__name__ == "FWPHOuterBound"][0]
    rel_gap = ws.spcomm.compute_gaps()[1]
    phase(label, S=batch.num_scenarios, model=model, hub_iters=iters,
          outer=outer, inner=inner, rel_gap=rel_gap,
          certified=rel_gap <= 0.01, fwph_bound=fwph.bound,
          ob_char=ws.spcomm.latest_ob_char, ib_char=ws.spcomm.latest_ib_char,
          wall_s=round(secs, 3), s_per_hub_iter=round(secs / iters, 4),
          plain_windows=plain,
          # with the 400 cold windows each of PH's iter0 and FWPH's init
          windows_per_hub_iter=round(plain / iters, 2), kernel_launches=0)
    if not (math.isfinite(outer) and outer <= inner):
        raise AssertionError(f"{label}: no finite outer bound, or bounds "
                             "crossed")
    if jax_outer is not None:
        rel = abs(outer - jax_outer) / abs(jax_outer)
        phase(label, jax_outer=jax_outer, outer_rel_diff_vs_jax=rel,
              tol=1e-3)
        if rel > 1e-3:
            raise AssertionError(f"{label}: outer bound off the JAX "
                                 "reference")
    return ws, secs


def count_launches(fn, reps):
    """Device kernels per call of fn (torch.profiler over `reps` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return len(device_spans(prof)) / reps


def busy_share(fn):
    """Device busy share of one call of fn: the union of device activity
    over the call's wall time (torch.profiler), and the device ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = device_spans(prof)
    total = sum(b - a for a, b in spans)
    return busy_us(spans) / (wall * 1e6), total / 1e3, wall


def ell_path(dev):
    """[ell_parity]: uc's ELL A at S=100, card against CPU (products and
    one plain window from each device's own cold state), then window
    times (40 iterations, and with their restart) at S=100, 1,000 and
    10,000, and the PyTorch launches of one iteration and one restart."""
    import dataclasses

    from mpisppy_tpu_torch.ops import pdhg
    cpu, card = uc_batch(UC_SCENS, "cpu"), uc_batch(UC_SCENS, dev)
    A = card.qp.A
    g = torch.Generator().manual_seed(0)
    x = torch.randn(UC_SCENS, card.qp.n, generator=g)
    y = torch.randn(UC_SCENS, card.qp.m, generator=g)
    errs = {}
    for name, cf, gf, v in (("matvec", cpu.qp.matvec, card.qp.matvec, x),
                            ("rmatvec", cpu.qp.rmatvec, card.qp.rmatvec,
                             y)):
        want, got = cf(v), gf(v.to(dev)).cpu()
        errs[name] = float((got - want).abs().max() / want.abs().max())
    opts = pdhg.PDHGOptions(tol=1e-6, restart_period=N_ITERS)
    want = pdhg.solve_fixed(cpu.qp, 1, opts, pdhg.init_state(cpu.qp, opts))
    got = pdhg.solve_fixed(card.qp, 1, opts, pdhg.init_state(card.qp, opts))
    torch.cuda.synchronize()
    for name, w, k in (("window_x", want.x, got.x), ("window_y", want.y,
                                                      got.y)):
        errs[name] = float((k.cpu() - w).abs().max() / w.abs().max())
    phase("ell_parity", S=UC_SCENS, model="uc_10g24h", m=card.qp.m,
          n=card.qp.n, k=A.k, kt=A.t_slots.shape[1],
          rel_err=json.dumps({k: f"{v:.3g}" for k, v in errs.items()})
          .replace(" ", ""), tol=1e-5)
    if max(errs.values()) > 1e-5:
        raise AssertionError("ell_parity: the card's ELL products or window "
                             "off the CPU's")

    ell_product_forms(A, dev)
    st0 = pdhg.solve_fixed(card.qp, 2, opts, pdhg.init_state(card.qp, opts))
    tau = opts.step_margin * st0.omega / st0.Lnorm
    sigma = opts.step_margin / (st0.omega * st0.Lnorm)
    reset_launches()
    for S in ELL_SCENS:
        reps = S // UC_SCENS
        qp = dataclasses.replace(card.qp, **{
            f: repeat_rows(getattr(card.qp, f), reps)
            for f in ("c", "q", "bl", "bu")})
        st = dataclasses.replace(st0, **{
            f.name: repeat_rows(getattr(st0, f.name), reps)
            for f in dataclasses.fields(st0)
            if isinstance(getattr(st0, f.name), torch.Tensor)
            and getattr(st0, f.name).ndim >= 1})
        t, sg = repeat_rows(tau, reps), repeat_rows(sigma, reps)

        def iters():
            s_ = st
            for _ in range(N_ITERS):
                s_ = pdhg._pdhg_iter(qp, s_, t, sg)
            return s_
        it_ms = time_ms(iters, reps=3)
        win_ms = time_ms(lambda: pdhg._window(qp, st, opts), reps=3)
        fields = {}
        if S == ELL_SCENS[0]:
            fields["launches_per_iter"] = count_launches(
                lambda: pdhg._pdhg_iter(qp, st, t, sg), 10)
            fields["launches_per_restart"] = count_launches(
                lambda: pdhg._restart(qp, st, opts), 5)
        phase("ell_parity", S=S, n_iters=N_ITERS, iters_ms=round(it_ms, 3),
              window_ms=round(win_ms, 3), **fields)
        del qp, st
        torch.cuda.empty_cache()
    check_no_kernel("ell_parity")


def ell_product_forms(A, dev):
    """ms of A x plus A'y over uc's shared ELL A in both forms, timed in
    turns (gather, bag, bag, gather) at each of ELL_PRODUCT_SCENS, and
    the form the size rule picks (sparse.BAG_MIN_ELEMENTS)."""
    from mpisppy_tpu_torch.ops import sparse
    g = torch.Generator().manual_seed(1)
    for S in ELL_PRODUCT_SCENS:
        x = torch.randn(S, A.n, generator=g).to(dev)
        y = torch.randn(S, A.m, generator=g).to(dev)
        tv = A._t_vals()
        forms = {
            "gather": lambda: (
                sparse._gather_product(A.cols, A.vals, x),
                sparse._gather_product(A.t_rows, tv, y)),
            "bag": lambda: (sparse._bag_product(A.cols, A.vals, x),
                            sparse._bag_product(A.t_rows, tv, y))}
        ms = {k: [] for k in forms}
        for k in ("gather", "bag", "bag", "gather"):
            ms[k].append(time_ms(forms[k], reps=10))
        rule = ["bag" if S * idx.numel() >= sparse.BAG_MIN_ELEMENTS
                else "gather" for idx in (A.cols, A.t_rows)]
        phase("ell_products", S=S, **{f"{k}_ms": "/".join(
              f"{v:.4f}" for v in ms[k]) for k in ms},
              rule_Ax=rule[0], rule_ATy=rule[1])
        del x, y
    torch.cuda.empty_cache()


def uc_fwph_hub(dev):
    """[uc_fwph_hub]: bench.py's bench_uc_fwph_hub loop, FWPH driving (2
    inner iterations, 16 columns, rho 200, 10 oracle windows, f32), the
    incumbent from x̄ rounded to nearest and up, each gated by comp_tight,
    capped at UC_FWPH_OUTER_ITERS outer iterations (x̂ every 5th)."""
    from mpisppy_tpu_torch.algos import fwph
    from mpisppy_tpu_torch.algos import xhat
    from mpisppy_tpu_torch.ops import pdhg
    batch = uc_batch(UC_SCENS, dev)
    opts = fwph.FWPHOptions(
        fw_iter_limit=2, max_columns=16,
        max_iterations=UC_FWPH_OUTER_ITERS, conv_thresh=0.0,
        default_rho=200.0, oracle_windows=10,
        pdhg=pdhg.PDHGOptions(tol=1e-6, restart_period=N_ITERS))
    xhat_opts = pdhg.PDHGOptions(tol=1e-6, max_iters=4_000)
    reset_launches()
    t0 = time.perf_counter()
    drv = fwph.FWPH(opts, batch)
    drv.fw_prep()
    best_outer, best_inner = drv.best_bound, math.inf
    for itr in range(1, opts.max_iterations + 1):
        drv.state = fwph.fwph_iter(batch, drv.state, opts)
        best_outer = max(best_outer, float(drv.state.best_bound))
        if itr % 5 == 0:
            for mode in ("nearest", "ceil"):
                cand = xhat.round_integers(batch, drv.state.xbar_nodes, mode)
                res = xhat.evaluate(batch, cand, xhat_opts)
                if bool(res.feasible) and xhat.comp_tight(batch, res):
                    best_inner = min(best_inner, float(res.value))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_no_kernel("uc_fwph_hub")
    rel_gap = (best_inner - best_outer) / max(abs(best_inner),
                                              abs(best_outer), 1e-12)
    rel = abs(best_outer - UC_FWPH_HUB_JAX_OUTER) / UC_FWPH_HUB_JAX_OUTER
    phase("uc_fwph_hub", S=UC_SCENS, outer_iters=opts.max_iterations,
          certified_outer=best_outer, inner=best_inner, rel_gap=rel_gap,
          jax_outer=UC_FWPH_HUB_JAX_OUTER, outer_rel_diff_vs_jax=rel,
          last_bound=float(drv.state.bound),
          certified=bool(drv.state.certified), wall_s=round(secs, 3),
          s_per_outer_iter=round(secs / opts.max_iterations, 4))
    if not (math.isfinite(best_outer) and best_outer <= best_inner
            and rel <= 1e-3):
        raise AssertionError("uc_fwph_hub: no certified FWPH bound, above "
                             "the incumbent or off the JAX reference")


def uc_program(dev):
    """[uc_program]: the uc program's VirtualBatch at UC_PROGRAM_SCENS
    scenarios (demand drawn at every step entry; the ELL template
    shared): its
    resident bytes, UC_PROGRAM_HUB_ITERS hub iterations of the uc wheel,
    and the device busy share of two of the hub's subproblem windows."""
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.core.batch import concretize
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops import pdhg
    vb = scengen.virtual_batch(uc.scenario_program(
        UC_PROGRAM_SCENS, seed=0, n_gens=UC_GENS, n_hours=UC_HOURS),
        device=dev)
    torch.cuda.reset_peak_memory_stats()
    phase("uc_program", S=UC_PROGRAM_SCENS,
          persistent_bytes=vb.persistent_bytes(),
          materialized_bytes=vb.materialized_bytes())
    ws, _ = uc_wheel_phase("uc_program", vb, UC_PROGRAM_HUB_ITERS,
                           model="uc_10g24h_scengen")
    qp = concretize(vb).qp
    st = ws.opt.state.solver
    opts = ws.opt.options.pdhg
    share, device_ms, wall = busy_share(
        lambda: pdhg.solve_fixed(qp, 2, opts, st))
    phase("uc_program", profile="2 hub subproblem windows",
          device_busy_share=round(share, 4), device_ms=round(device_ms, 3),
          wall_s=round(wall, 4),
          peak_bytes=torch.cuda.max_memory_allocated())


def uc_path(dev):
    """The uc phases (an ELL A: the plain batched iteration, no kernel)."""
    ell_path(dev)
    torch.cuda.empty_cache()
    uc_wheel_phase("uc_wheel", uc_batch(UC_SCENS, dev), UC_WHEEL_HUB_ITERS,
                   jax_outer=UC_WHEEL_JAX_OUTER)
    torch.cuda.empty_cache()
    uc_fwph_hub(dev)
    torch.cuda.empty_cache()
    uc_program(dev)


def uc_wheel_full(dev):
    """The uc wheel at 100 scenarios to its 1% certificate (at most
    UC_FULL_MAX_ITERS hub iterations); not in the default run."""
    uc_wheel_phase("uc_wheel_full", uc_batch(UC_SCENS, dev),
                   UC_FULL_MAX_ITERS)


def sslp_program(S, n_servers=SSLP_SERVERS, n_clients=SSLP_CLIENTS):
    """The sslp program (LP relaxation), seed 0: ClientPresent drawn
    from threefry keys instead of scenario_creator's RandomState."""
    from mpisppy_tpu_torch.models import sslp
    return sslp.scenario_program(S, seed=0, n_servers=n_servers,
                                 n_clients=n_clients, lp_relax=True)


def scengen_path(dev):
    """The scengen phases: the VirtualBatch build at S=1,000,000, the
    SYNTH kernel against the box kernel on the realized batch and
    against its plain version, its window times, the S=64 VirtualBatch
    wheel three ways, and the sslp 15x45 VirtualBatch wheel at
    S=10,000."""
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.ops import pdhg_window
    run = pdhg_window.run_window

    S_big = SCENGEN_SCENS[-1]
    t0 = time.perf_counter()
    big = scengen.virtual_batch(sslp_program(S_big), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    realize_ms = time_ms(big.realize, reps=3)
    phase("scengen_build", S=S_big, model="sslp_15_45",
          persistent_bytes=big.persistent_bytes(),
          materialized_bytes=big.materialized_bytes(),
          build_s=round(build_s, 3), realize_ms=round(realize_ms, 3))
    del big

    base = window_inputs(scengen.virtual_batch(
        sslp_program(SCENGEN_BASE_SCENS), device=dev).realize(), seed=3)
    errs, timing = {}, {}
    for S in SCENGEN_SCENS:
        vb = scengen.virtual_batch(sslp_program(S), device=dev)
        state = tiled_state(base, S // SCENGEN_BASE_SCENS)
        box_args = (vb.realize().qp,) + state + (N_ITERS,)
        proxy, synth = scengen.window_inputs(vb)
        syn_args = (proxy,) + state + (N_ITERS,)
        for mode in ("f32", "bf16x3"):
            k = run(*syn_args, precision=mode, synth=synth,
                    design="resident")
            b = run(*box_args, precision=mode, design="resident")
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(k, b))
            phase("parity_synth", S=S, mode=mode, design="resident",
                  equal_to_box=same)
            if not same:
                raise AssertionError(f"synth kernel differs from the box "
                                     f"kernel on the realized batch ({mode})")
            del k, b
            if S == SCENGEN_SCENS[0]:
                errs[mode] = parity(syn_args, mode, "parity_synth", S,
                                    synth=synth, design="resident",
                                    vs="plain")[0]
        torch.cuda.empty_cache()
        # counts from 0 just before and read just after: the synth path's
        # launches are those of this timing phase (the shape rule's design;
        # the streamed body is timed beside it at the smaller S)
        reset_launches()
        reps = 5 if S <= SCENGEN_SCENS[0] else 2
        for mode in ("f32", "bf16x3"):
            ms = time_ms(lambda: run(*syn_args, precision=mode,
                                     synth=synth), reps=reps)
            box_ms = time_ms(lambda: run(*box_args, precision=mode),
                             reps=reps)
            streamed = {}
            if S == SCENGEN_SCENS[0]:
                streamed["streamed_ms"] = round(time_ms(lambda: run(
                    *syn_args, precision=mode, synth=synth,
                    design="streamed"), reps=reps), 3)
            plain = time_ms(lambda: pdhg_window.run_window_reference(
                *syn_args, precision=mode, synth=synth), reps=1)
            bound, by = window_bound_ms(syn_args, mode, synth)
            timing[S, mode] = (ms, plain, bound, by)
            phase("window_time_synth", S=S, mode=mode, n_iters=N_ITERS,
                  kernel_ms=round(ms, 3), box_kernel_ms=round(box_ms, 3),
                  **streamed, plain_ms=round(plain, 3),
                  bound_ms=round(bound, 4), bound_by=by)
            torch.cuda.empty_cache()
        launches = pdhg_window.run_window.launches["pdhg_window_synth"]
        resident = sum(v for k, v in
                       pdhg_window.run_window.launches_by_design.items()
                       if k.startswith("pdhg_window_synth/")
                       and k.endswith("/resident"))
        phase("window_time_synth", S=S, synth_launches=launches,
              resident=resident)
        if launches <= 0 or resident <= 0:
            raise AssertionError("no resident pdhg_window_synth launches")
        del vb, state, box_args, proxy, syn_args
        torch.cuda.empty_cache()
    del base

    prog = sslp_program(SCENGEN_SMALL_SCENS, 5, 15)
    opts = sslp_options(None, 200, 1e-7, 10)
    g = small_wheel("scengen_small", "sslp_5_15_scengen",
                    scengen.virtual_batch(prog, device=dev),
                    scengen.virtual_batch(prog, device="cpu"), opts)
    m, _ = wheel(scengen.materialize(prog, device=dev), opts)
    same = (m.BestOuterBound, m.BestInnerBound, m.spcomm._iter) == (
        g.BestOuterBound, g.BestInnerBound, g.spcomm._iter)
    phase("scengen_small", S=SCENGEN_SMALL_SCENS, materialized_outer=
          m.BestOuterBound, materialized_inner=m.BestInnerBound,
          materialized_iters=m.spcomm._iter, identical_to_virtual=same)
    if not same:
        raise AssertionError("scengen_small: the VirtualBatch wheel and the "
                             "materialized wheel differ on the card")

    # the full-width path: the sslp 15x45 program's VirtualBatch through
    # the headline's wheel
    vb = scengen.virtual_batch(sslp_program(HEADLINE_SCENS), device=dev)
    ws, _, by_design = main_wheel(
        "scengen_wheel", "pdhg_window", vb,
        sslp_options("bf16x3", SCENGEN_WHEEL_ITERS, 1e-6, 8),
        model="sslp_15_45_scengen", iter_precision="bf16x3")
    check_designs("scengen_wheel", by_design, vb.qp.m, vb.qp.n,
                  (HEADLINE_SCENS, TAIL_SCENS))
    return kernel_entry("pdhg_window_synth", RESIDENT_SOURCE,
                        "mpisppy_tpu/ops/pdhg_pallas.py:624", launches,
                        errs["bf16x3"], timing[S_big, "bf16x3"])


def mip_node_lp(max_iters=MIP_NODE_MAX_ITERS):
    from mpisppy_tpu_torch.ops import pdhg
    return pdhg.PDHGOptions(tol=1e-5, max_iters=max_iters)


def mip_gap_options():
    """[mip_gap]'s BnBOptions (tools/mip_jax_reference.py uses the same)."""
    from mpisppy_tpu_torch.ops import bnb
    return bnb.BnBOptions(max_rounds=MIP_GAP_MAX_ROUNDS,
                          pool_size=MIP_GAP_POOL,
                          dive_tail=MIP_GAP_DIVE_TAIL,
                          pump_rounds=MIP_GAP_PUMP_ROUNDS,
                          lp=mip_node_lp(MIP_GAP_NODE_MAX_ITERS))


# tests/test_torch_mip_gap.py's lean budgets for the small sslp runs
MIP_LEAN = dict(gap_tol=1e-3, pool_size=16, max_rounds=60, dive_tail=16,
                pump_rounds=0)


def sslp_mip_batch(S, n_servers, n_clients, device, seed=0):
    """Synthetic sslp with its integer recourse (not LP-relaxed): the
    exact-MIP plane's problem, one dense shared (m, n) A."""
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import sslp
    inst = sslp.synthetic_instance(n_servers, n_clients, seed=seed)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=S)
             for nm in sslp.scenario_names_creator(S)]
    return batch_mod.from_specs(specs, device=device), specs


class MipCounts:
    """Counts, while active, the restart windows (pdhg._window), the B&B
    rounds (bnb.bnb_round) with their windows and seconds, and the box
    kernel's launches by instantiation/mode/design (reset on entry)."""

    def __init__(self):
        self.windows = 0
        self.rounds = 0
        self.round_windows = 0
        self.round_s = 0.0

    def __enter__(self):
        from mpisppy_tpu_torch.ops import bnb, pdhg
        self._real = (pdhg._window, bnb.bnb_round)
        real_window, real_round = self._real

        def window(p, st, opts):
            self.windows += 1
            return real_window(p, st, opts)

        def bnb_round(*a, **k):
            w0 = self.windows
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_round(*a, **k)
            torch.cuda.synchronize()
            self.round_s += time.perf_counter() - t0
            self.rounds += 1
            self.round_windows += self.windows - w0
            return out

        pdhg._window, bnb.bnb_round = window, bnb_round
        reset_launches()
        return self

    def __exit__(self, *exc):
        from mpisppy_tpu_torch.ops import bnb, pdhg, pdhg_window
        pdhg._window, bnb.bnb_round = self._real
        self.by_design = dict(pdhg_window.run_window.launches_by_design)
        self.launches = dict(pdhg_window.run_window.launches)
        return False

    def fields(self):
        box = self.launches.get("pdhg_window", 0)
        return dict(rounds=self.rounds, windows=self.windows,
                    windows_per_round=round(self.round_windows
                                            / max(1, self.rounds), 2),
                    s_per_round=round(self.round_s / max(1, self.rounds), 4),
                    box_kernel_launches=box,
                    by_design=json.dumps(self.by_design, sort_keys=True)
                    .replace(" ", ""))


def bnb_node_args(batch, seed=0):
    """B&B node operands at the batch's shapes: the integer root box,
    lane s's first (s mod 97) integer columns fixed (l == u at 0 or 1),
    lane 3's first integer column emptied (l > u), a window input two
    windows into the solve (warm state) with every 7th lane done.
    Returns (window args, node qp, the emptied column)."""
    import dataclasses

    from mpisppy_tpu_torch.ops import bnb
    qp, dev = batch.qp, batch.device
    ic = torch.nonzero(batch.integer_full)[:, 0]
    lo, hi = (torch.as_tensor(v, device=dev) for v in
              bnb._root_bounds(qp, batch.d_col, ic.cpu().numpy()))
    S = qp.c.shape[0]
    k = torch.arange(S, device=dev) % 97
    fixed = torch.arange(ic.numel(), device=dev)[None, :] < k[:, None]
    val = (torch.arange(S, device=dev) % 2).to(lo.dtype)[:, None]
    lo = torch.where(fixed, val.expand_as(lo), lo)
    hi = torch.where(fixed, val.expand_as(hi), hi)
    lo[3, 0], hi[3, 0] = 1.0, 0.0
    node = bnb._node_qp(qp, batch.d_col, ic, lo, hi)
    nb = dataclasses.replace(batch, qp=node)
    return window_inputs(nb, seed=seed), node, int(ic[0])


def bnb_operands(dev, S):
    """[bnb_operands]: the box kernel (K1 f32, K2 bf16x3, the design the
    shape rule gives) against its plain version on B&B node operands at
    sslp 15x45, S scenarios, and one window's times.  Returns
    ({mode: max_abs_err}, {mode: timing})."""
    batch, _ = sslp_mip_batch(S, SSLP_SERVERS, SSLP_CLIENTS, dev)
    args, node, col = bnb_node_args(batch)
    errs, timing = {}, {}
    for mode in ("f32", "bf16x3"):
        err, k = parity(args, mode, "bnb_operands", S,
                        bounds="node_boxes_fixed_and_emptied")
        clipped = float(k[0][3, col]) == float(node.u[3, col])
        phase("bnb_operands", mode=mode, emptied_box_lane=3,
              x_at_emptied_column_equals_u=clipped)
        if not clipped:
            raise AssertionError("bnb_operands: an emptied box did not "
                                 "clip to its upper bound")
        errs[mode] = err
    t = time_designs(args, "window_time_bnb", ("resident",), reps=10,
                     shape="bnb_node")
    for mode in ("f32", "bf16x3"):
        timing[mode] = t[S, mode, "resident"]
    return errs, timing


def mip_lagrangian(dev, S, ph_iters=MIP_LAG_PH_ITERS,
                   max_rounds=MIP_LAG_MAX_ROUNDS,
                   profile_rounds=MIP_PROFILE_ROUNDS):
    """[mip_lagrangian]: lagrangian_mip_bound at sslp 15x45, S scenarios,
    W from a short LP PH run, capped B&B rounds: rounds, nodes, windows,
    box-kernel launches, seconds, the bound — certified (every real
    scenario's outer finite) and not below the LP Lagrangian bound at the
    same W by more than MIP_LP_SLACK.  Then the device busy share of
    `profile_rounds` bare B&B rounds from the root (torch.profiler).
    Returns the counts."""
    from mpisppy_tpu_torch import dispatch
    from mpisppy_tpu_torch.algos import lagrangian, mip
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.ops import bnb
    batch, _ = sslp_mip_batch(S, SSLP_SERVERS, SSLP_CLIENTS, dev)
    drv = ph_mod.PH(ph_mod.PHOptions(max_iterations=ph_iters,
                                     default_rho=MIP_RHO, conv_thresh=0.0),
                    batch)
    drv.ph_main()
    W = drv.state.W
    lp = lagrangian.lagrangian_bound(batch, W)
    lp_bound = float(lp.bound)
    opts = bnb.BnBOptions(max_rounds=max_rounds,
                          pump_rounds=MIP_LAG_PUMP_ROUNDS, lp=mip_node_lp())
    dispatch.configure()
    with MipCounts() as c:
        t0 = time.perf_counter()
        lag = mip.lagrangian_mip_bound(batch, W, opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    res = lag["result"]
    nodes = int(res.nodes_solved.sum())
    certified = bool(torch.isfinite(res.outer).all())
    slack = MIP_LP_SLACK * max(1.0, abs(lp_bound))
    phase("mip_lagrangian", S=S, model="sslp_15_45_integer",
          ph_iters=ph_iters, max_rounds=max_rounds, seconds=round(secs, 3),
          nodes_solved=nodes, bound=lag["bound"], certified=certified,
          lp_lagrangian_bound=lp_bound,
          lp_bound_certified=bool(lp.certified),
          mip_minus_lp=lag["bound"] - lp_bound, slack=slack,
          scen_closed=int(lag["solved"].sum()), **c.fields())
    if not (certified and c.launches.get("pdhg_window", 0) > 0
            and lag["bound"] >= lp_bound - slack):
        raise AssertionError("mip_lagrangian: bound not certified, below "
                             "the LP Lagrangian bound, or no box-kernel "
                             "launches")
    mip_round_profile(dev, batch, W, opts, profile_rounds)
    return c


def mip_round_profile(dev, batch, W, opts, rounds):
    """Device busy share of `rounds` B&B rounds from the root state
    (cold warm start) under torch.profiler (device activity only), with
    the windows and launches per round."""
    from torch.profiler import ProfilerActivity, profile

    from mpisppy_tpu_torch.algos import mip
    from mpisppy_tpu_torch.ops import bnb
    qp = batch.with_nonant_linear_quad(W, torch.zeros_like(W))
    ic = mip._int_cols(batch)
    st = bnb.root_state(qp, batch.d_col, ic, opts)
    st = bnb.bnb_round(qp, batch.d_col, ic, st, opts)      # warm-up
    torch.cuda.synchronize()
    with MipCounts() as c:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                st = bnb.bnb_round(qp, batch.d_col, ic, st, opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans = device_spans(prof)
    busy = busy_us(spans) / (wall * 1e6) if spans else None
    phase("mip_round_profile", S=batch.num_scenarios,
          wall_s=round(wall, 3), device_busy_share=None if busy is None
          else round(busy, 4), device_kernels=len(spans),
          kernels_per_window=round(len(spans) / max(1, c.windows), 1),
          **c.fields())


def mip_gap(dev):
    """[mip_gap]: certified_mip_gap on sslp 15x45 at MIP_GAP_SCENS
    scenarios (SIPLIB sslp_15_45_10's dimensions, synthetic data) with
    tools/mip_jax_reference.py's budgets; its bracket must overlap the
    JAX package's (both certified).  Returns the counts."""
    from mpisppy_tpu_torch import dispatch
    from mpisppy_tpu_torch.algos import mip
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.ops import bnb
    batch, _ = sslp_mip_batch(MIP_GAP_SCENS, SSLP_SERVERS, SSLP_CLIENTS,
                              dev)
    dispatch.configure()
    with MipCounts() as c:
        t0 = time.perf_counter()
        res = mip.certified_mip_gap(
            batch, ph_mod.PHOptions(max_iterations=MIP_GAP_PH_ITERS,
                                    default_rho=MIP_RHO),
            mip_gap_options(), dd_nodes=MIP_GAP_DD_NODES)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    j_inner, j_outer = MIP_GAP_JAX
    j_gap = (j_inner - j_outer) / max(1.0, abs(j_inner))
    tol = 1e-6 * max(1.0, abs(j_inner))
    overlap = res.outer <= j_inner + tol and j_outer <= res.inner + tol
    phase("mip_gap", S=MIP_GAP_SCENS, model="sslp_15_45_integer",
          inner=res.inner, outer=res.outer, gap=res.gap,
          seconds=round(secs, 3), jax_inner=j_inner, jax_outer=j_outer,
          jax_gap=j_gap, overlaps_jax=overlap,
          dispatch=json.dumps({k: v for k, v in dispatch.scheduler_stats()
                               .items() if k in ("batches", "lanes",
                                                 "pad_lanes", "buckets")})
          .replace(" ", ""), **c.fields())
    if not (math.isfinite(res.inner) and math.isfinite(res.outer)
            and overlap and c.launches.get("pdhg_window", 0) > 0):
        raise AssertionError("mip_gap: bracket not finite, no overlap "
                             "with the JAX package's, or no launches")
    return c


def random_mips(S=4, n=8, m=5, seed=3):
    """tests/test_mip_bnb.py's random feasible bounded MIPs (per-scenario
    A) as arrays, with their scipy HiGHS MILP optima."""
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp
    rng = np.random.RandomState(seed)
    c = rng.randn(S, n)
    A = rng.randn(S, m, n) * (rng.rand(S, m, n) < 0.6)
    x0 = rng.randint(0, 3, size=(S, n)).astype(float)
    bu = np.einsum("smn,sn->sm", A, x0) + rng.rand(S, m) * 2.0
    bl = np.full((S, m), -np.inf)
    lo, up = np.zeros((S, n)), np.full((S, n), 4.0)
    ref = np.array([milp(c[s], constraints=LinearConstraint(A[s], bl[s],
                                                            bu[s]),
                         bounds=Bounds(lo[s], up[s]),
                         integrality=np.ones(n)).fun for s in range(S)])
    return (c, A, bl, bu, lo, up), ref


def ef_oracle(specs):
    """The scipy HiGHS MILP optimum of the unscaled dense extensive form
    (tests/test_mip_bnb.py::_sslp_ef_oracle)."""
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp

    from mpisppy_tpu_torch.algos import ef as ef_mod
    efp = ef_mod.build_ef(specs, scale=False, sparse=False, device="cpu")
    n = efp.n_per_scen
    integer = np.zeros(efp.qp.n, bool)
    for s, sp in enumerate(specs):
        integer[s * n:(s + 1) * n] = sp.integer
    q = efp.qp
    r = milp(q.c.double().numpy(), constraints=LinearConstraint(
        q.A.double().numpy(), q.bl.double().numpy(), q.bu.double().numpy()),
        bounds=Bounds(q.l.double().numpy(), q.u.double().numpy()),
        integrality=integer.astype(int))
    if not r.success:
        raise AssertionError("ef_oracle: scipy milp failed")
    return float(r.fun)


def in_bracket(label, inner, outer, ref, rtol=2e-3):
    """The certified bracket [outer, inner] contains the oracle `ref` to
    rtol * (1 + |ref|)."""
    import numpy as np
    inner, outer, ref = (np.atleast_1d(np.asarray(v, float))
                         for v in (inner, outer, ref))
    tol = rtol * (1.0 + np.abs(ref))
    ok = bool(np.all(outer <= ref + tol) and np.all(inner >= ref - tol))
    phase(label, oracle=json.dumps([float(v) for v in ref]),
          inner=json.dumps([float(v) for v in inner]),
          outer=json.dumps([float(v) for v in outer]),
          tol=f"{rtol}*(1+|oracle|)", contains_oracle=ok)
    if not ok:
        raise AssertionError(f"{label}: the bracket misses the oracle")


def mip_small(dev):
    """[mip_small]: solve_mip on tests/test_mip_bnb.py's random MIPs (a
    per-scenario A: the plain batched iteration), then ef_mip (a batch
    of one with a dense shared A: the box kernel) and certified_mip_gap
    on sslp 4x8 at S=4 — every bracket must contain the scipy MILP
    optimum.  Returns the counts."""
    from mpisppy_tpu_torch import dispatch
    from mpisppy_tpu_torch.algos import ef as ef_mod
    from mpisppy_tpu_torch.algos import mip
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.ops import bnb, boxqp
    dispatch.configure()
    with MipCounts() as c:
        arrays, ref = random_mips()
        qp = boxqp.make_boxqp(*arrays, device=dev)
        t0 = time.perf_counter()
        res = dispatch.solve_mip(qp, torch.ones(qp.n, device=dev),
                                 list(range(qp.n)),
                                 bnb.BnBOptions(pool_size=32,
                                                max_rounds=300))
        torch.cuda.synchronize()
        phase("mip_small", problem="random_mips_4x8x5",
              seconds=round(time.perf_counter() - t0, 3))
        in_bracket("mip_small", res.inner.cpu(), res.outer.cpu(), ref,
                   rtol=1e-3)
        inst_batch, specs = sslp_mip_batch(4, 4, 8, dev, seed=2)
        ref = ef_oracle(specs)
        opts = bnb.BnBOptions(**MIP_LEAN)
        t0 = time.perf_counter()
        r = mip.ef_mip(ef_mod.build_ef(specs, device=dev), specs, opts)
        phase("mip_small", problem="ef_mip_sslp_4_8_S4", nodes=r["nodes"],
              seconds=round(time.perf_counter() - t0, 3))
        in_bracket("mip_small", r["inner"], r["outer"], ref)
        t0 = time.perf_counter()
        g = mip.certified_mip_gap(
            inst_batch, ph_mod.PHOptions(max_iterations=MIP_SMALL_PH_ITERS,
                                         default_rho=10.0),
            bnb.BnBOptions(**MIP_LEAN,
                           lp=mip_node_lp(MIP_SMALL_NODE_MAX_ITERS)),
            dd_nodes=MIP_SMALL_DD_NODES)
        phase("mip_small", problem="certified_mip_gap_sslp_4_8_S4",
              gap=g.gap, seconds=round(time.perf_counter() - t0, 3))
        in_bracket("mip_small", g.inner, g.outer, ref)
    phase("mip_small", **c.fields())
    if c.launches.get("pdhg_window", 0) <= 0:
        raise AssertionError("mip_small: the EF's node LPs launched no box "
                             "kernel")
    return c


def dispatch_phase(dev):
    """[dispatch]: a padded solve_mip (5 lanes padded to 8) against the
    direct one on the card (lane equality, or the measured band within
    gap_tol), decomposition_bnb's node fan-out coalesced into megabatches
    with the scheduler's stats, and the CLI with --dispatch-max-batch and
    --dispatch-timeout-s.  Returns the counts of the solves."""
    from mpisppy_tpu_torch import dispatch
    from mpisppy_tpu_torch.algos import mip
    from mpisppy_tpu_torch.ops import bnb
    lean = bnb.BnBOptions(pool_size=8, max_rounds=20, dive_rounds=4,
                          dive_tail=8, pump_rounds=0)
    with MipCounts() as c:
        batch, _ = sslp_mip_batch(5, 5, 15, dev, seed=3)
        W = torch.zeros((5, batch.num_nonants), device=dev)
        qp = batch.with_nonant_linear_quad(W, torch.zeros_like(W))
        ic = mip._int_cols(batch)
        direct = bnb.solve_mip(qp, batch.d_col, ic, lean)
        sched = dispatch.SolveScheduler()
        via = sched.solve_mip(qp, batch.d_col, ic, lean)
        diffs = {f: float(torch.nan_to_num(
            (getattr(direct, f) - getattr(via, f)).abs(), nan=0.0,
            posinf=0.0).max()) for f in ("inner", "outer")}
        equal = all(torch.equal(getattr(direct, f), getattr(via, f))
                    for f in ("inner", "outer", "x", "feasible"))
        band = lean.gap_tol * (1.0 + float(direct.inner[
            torch.isfinite(direct.inner)].abs().max()))
        st = sched.stats()
        phase("dispatch", check="padded_vs_direct", lanes=st["lanes"],
              pad_lanes=st["pad_lanes"], lanes_bit_equal=equal,
              max_abs_diff=json.dumps(diffs).replace(" ", ""), band=band)
        if not (torch.equal(direct.feasible, via.feasible)
                and max(diffs.values()) <= band):
            raise AssertionError("dispatch: padded solve off the direct "
                                 "one beyond gap_tol")
        dispatch.configure()
        fan, _ = sslp_mip_batch(3, 3, 6, dev, seed=4)
        t0 = time.perf_counter()
        dd = mip.decomposition_bnb(
            fan, torch.zeros((3, fan.num_nonants), device=dev), lean,
            max_nodes=6, node_fanout=3)
        st = dispatch.scheduler_stats()
        phase("dispatch", check="decomposition_fanout", nodes=dd["nodes"],
              inner=dd["inner"], outer=dd["outer"],
              seconds=round(time.perf_counter() - t0, 3),
              batches=st["batches"], lanes=st["lanes"],
              pad_lanes=st["pad_lanes"],
              coalesced_lanes=st["coalesced_lanes"],
              occupancy=round(st["occupancy"], 4), signatures=st["buckets"],
              by_cause=json.dumps(st["by_cause"]).replace(" ", ""))
        if not (st["coalesced_lanes"] > 0
                and dd["outer"] <= dd["inner"] + 1e-6):
            raise AssertionError("dispatch: the node fan-out did not "
                                 "coalesce, or its bracket crossed")
    result, _, _, _ = cli_run("dispatch", CLI_DISPATCH, box_kernel=False)
    o = dispatch.get_scheduler().options
    phase("dispatch", check="cli", max_batch=o.max_batch,
          dispatch_timeout_s=o.dispatch_timeout_s,
          dispatch_retries=result["dispatch_retries"],
          dispatch_quarantined_lanes=result["dispatch_quarantined_lanes"])
    if (o.max_batch, o.dispatch_timeout_s) != (64, 600.0) \
            or "dispatch_retries" not in result:
        raise AssertionError("dispatch: the CLI's --dispatch-* flags did "
                             "not configure the scheduler")
    dispatch.configure()
    return c


def cli_ef():
    """[cli_ef]: python -m mpisppy_tpu_torch ... --EF on farmer (3
    scenarios) in this process, on the card: its EF_objective against
    the JAX CLI's."""
    import contextlib
    import io

    from mpisppy_tpu_torch import generic_cylinders
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ef = generic_cylinders.main(list(CLI_EF))
    torch.cuda.synchronize()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    rel = abs(result["EF_objective"] - CLI_EF_JAX_OBJ) / abs(CLI_EF_JAX_OBJ)
    phase("cli_ef", device=ef.ef.qp.device.type,
          EF_objective=result["EF_objective"],
          converged=result["converged"], jax_EF_objective=CLI_EF_JAX_OBJ,
          rel_diff_vs_jax=rel, tol=1e-4,
          wall_s=round(time.perf_counter() - t0, 3))
    if ef.ef.qp.device.type != "cuda" or not result["converged"] \
            or rel > 1e-4:
        raise AssertionError("cli_ef: not on the card, not converged, or "
                             "off the JAX CLI's EF objective")


def mip_path(dev):
    """The exact-MIP phases.  Returns ([bnb_operands] errors and timings,
    the box kernel's launches by design over the MIP phases)."""
    errs, timing = bnb_operands(dev, MIP_SCENS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    total = {}
    for run in (lambda: mip_lagrangian(dev, MIP_SCENS), lambda: mip_gap(dev),
                lambda: mip_small(dev), lambda: dispatch_phase(dev)):
        merge_launches(total, run().by_design)
        torch.cuda.empty_cache()
    cli_ef()
    phase("mip_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return errs, timing, total



def plan_line(qp, S, mode="f32"):
    """The design plan_window gives a window of `qp` at S scenarios
    (the SOC layout's ints with cones), as design/tile/blocks."""
    from mpisppy_tpu_torch.ops import pdhg_window
    cone_ints = 0
    if qp.cones is not None and qp.cones.num_cones > 0:
        _, rows = qp.cones.csr(qp.device)
        cone_ints = qp.cones.num_cones + 1 + rows.numel() + qp.m
    plan = pdhg_window.plan_window(
        mode, qp.m, qp.n, S, *pdhg_window.card_limits(
            torch.cuda.current_device()), cone_ints=cone_ints)
    return f"{plan.design}/T{plan.tile}/blocks{plan.blocks}"


def random_state_args(qp, seed=5):
    """Window inputs at a random mid-solve point of one problem: x
    uniform in its box (within 1 of a finite side where the other is
    infinite), normal duals on the rows with a finite side, no done
    lane."""
    from mpisppy_tpu_torch.ops import pdhg
    opts = pdhg.PDHGOptions(restart_period=N_ITERS)
    st = pdhg.init_state(qp, opts)
    g = torch.Generator(device="cpu").manual_seed(seed)
    dev = qp.c.device

    def draw(t, normal=False):
        r = torch.randn if normal else torch.rand
        return r(t.shape, generator=g).to(dev)
    l, u = torch.broadcast_to(qp.l, st.x.shape), \
        torch.broadcast_to(qp.u, st.x.shape)  # noqa: E741
    lo = torch.where(torch.isfinite(l), l, torch.where(
        torch.isfinite(u), u - 1.0, torch.zeros_like(u)))
    hi = torch.where(torch.isfinite(u), u, lo + 1.0)
    x = lo + (hi - lo) * draw(st.x)
    sided = torch.isfinite(torch.broadcast_to(qp.bl, st.y.shape)) \
        | torch.isfinite(torch.broadcast_to(qp.bu, st.y.shape))
    y = torch.where(sided, draw(st.y, normal=True), torch.zeros_like(st.y))
    tau = opts.step_margin * st.omega / st.Lnorm
    sigma = opts.step_margin / (st.omega * st.Lnorm)
    return (qp, x, y, torch.zeros_like(x), torch.zeros_like(y), tau, sigma,
            torch.zeros_like(st.done), N_ITERS)


def held_window(label, qp, args, soc=False, **extra):
    """parity() of one window of a new batch shape in f32 and bf16x3 at
    TOLS, in the design plan_window gives (printed as its route); the
    window must move x and y (a state at a fixed point checks nothing).
    SOC windows also keep their duals in the polar cone.  Returns
    {mode: max_abs_err}."""
    from mpisppy_tpu_torch.ops import cones
    S = args[1].shape[0]
    errs = {}
    for mode in ("f32", "bf16x3"):
        errs[mode], k = parity(args, mode, "slice9_windows", S, shape=label,
                               m=qp.m, n=qp.n, route=plan_line(qp, S, mode),
                               **extra)
        moved_x = float((k[0] - args[1]).abs().max())
        moved_y = float((k[1] - args[2]).abs().max())
        dcr = float(cones.dual_cone_residual_rows(qp.cones, k[1]).max()) \
            if soc else 0.0
        phase("slice9_windows", shape=label, mode=mode, moved_x=moved_x,
              moved_y=moved_y, polar_cone_residual=dcr)
        if not (moved_x > 0.0 and moved_y > 0.0 and dcr <= POLAR_TOL):
            raise AssertionError(f"{label}: the window left x or y where "
                                 "it was, or duals left the polar cone")
    return errs


def slice9_windows(dev):
    """[slice9_windows]: one window of each new batch shape, kernel
    against plain version at TOLS in the design the shape rule gives, in
    f32 and bf16x3: L-shaped's fixed-nonant subproblems (per-scenario
    nonant boxes), the single- and multi-cut L-shaped masters (one
    problem; cut buffers holding the cuts of one inexact round of
    subproblem solves; from a random mid-solve state) and APH's prox
    batch (q = rho on the nonants), at S=1,000; the cross-scenario PH
    view (sslp's rows and 800 cut rows, of which sslp's complete
    recourse leaves the feasibility rows empty) and EF view (cut rows
    with the eta columns, each scenario's own eta pinned) of sslp 5x15
    at S=100 after one round of cuts from x̂."""
    import types

    import numpy as np

    from mpisppy_tpu_torch.algos import cross_scen, lshaped
    from mpisppy_tpu_torch.ops import pdhg
    batch = sslp_batch(LSHAPED_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    N, S = batch.num_nonants, batch.num_scenarios
    xhat = torch.full((N,), 0.5, device=dev)
    cut_opts = pdhg.PDHGOptions(tol=1e-6, max_iters=400, detect_infeas=True)
    shapes = {"lshaped_subproblems": (batch.with_fixed_nonants(xhat), 7)}
    # the cut pieces of one round of capped subproblem solves at x̂
    res = lshaped._subproblem_cuts(batch, xhat, cut_opts)
    g = res["g"].double().cpu().numpy()
    alpha = res["alpha"].double().cpu().numpy()
    dual = res["dual"].double().cpu().numpy()
    p = batch.p.double().cpu().numpy()
    for multicut in (False, True):
        ls = lshaped.LShapedMethod(lshaped.LShapedOptions(
            multicut=multicut), batch)
        n_eta = S if multicut else 1
        cuts_A = np.zeros((ls.options.max_cuts, N + n_eta))
        bl = np.full(ls.options.max_cuts, -np.inf)
        if multicut:
            k = min(ls.options.max_cuts, S)
            cuts_A[np.arange(k), :N] = -g[:k]
            cuts_A[np.arange(k), N + np.arange(k)] = 1.0
            bl[:k] = alpha[:k]
            eta_lb = dual - 0.05 * np.abs(dual) - 1.0
        else:
            cuts_A[0, :N] = -(p[:, None] * g).sum(0)
            cuts_A[0, N] = 1.0
            bl[0] = float((p * alpha).sum())
            ws = float((p * dual).sum())
            eta_lb = ws - 0.05 * abs(ws) - 1.0
        qp, _ = ls._master_qp(cuts_A, bl, np.full_like(bl, np.inf), eta_lb)
        label = "lshaped_master_" + ("multicut" if multicut else "single")
        shapes[label] = (qp, None)
    rho = torch.full((S, N), 20.0, device=dev)
    shapes["aph_prox"] = (batch.with_nonant_linear_quad(-rho * 0.5, rho), 7)
    del batch
    # the cross-scenario views after one round of cuts from x̂, the
    # scenario farthest from x̄ (launch_cuts), as [cross_scen] builds them
    cs = sslp_batch(100, 5, 15, dev)
    meta = cross_scen.make_meta(cs, np.full(100, -1e3))
    nonants = torch.rand((100, cs.num_nonants), generator=torch.Generator(
        device="cpu").manual_seed(6)).to(dev)
    cross_scen.write_cuts(meta, cross_scen.package_cuts(
        cross_scen.launch_cuts(cs, nonants, nonants.mean(0), cut_opts),
        cut_opts))
    owner = torch.arange(meta.S, device=dev).repeat(meta.max_rounds)
    shapes["cross_scen_ph_view"] = (meta.aug_ph.qp, 7)
    shapes["cross_scen_ef_view"] = (cross_scen._ef_bound_qp(
        meta.aug_ef, owner, torch.as_tensor(meta.is_opt, device=dev),
        torch.as_tensor(meta.eta_lb, device=dev), meta.n_orig), 7)
    errs = {}
    for label, (qp, done_every) in shapes.items():
        args = random_state_args(qp) if done_every is None else \
            window_inputs(types.SimpleNamespace(qp=qp), done_every=done_every)
        cut_rows = {}
        if label.startswith("cross_scen"):
            cut_rows["active_cut_rows"] = int(torch.isfinite(
                torch.broadcast_to(qp.bu, args[2].shape)[..., meta.m_orig:])
                .any(0).sum())
        for mode, err in held_window(label, qp, args, **cut_rows).items():
            errs[label, mode] = err
        del args
    del shapes, meta
    torch.cuda.empty_cache()
    return errs


def merge_launches(total, by_design):
    for k, v in by_design.items():
        total[k] = total.get(k, 0) + v


def slice9_runs(table, name, check):
    """Each run of phase `name` in `config` through cli_run, `check`
    applied to the first, the JAX-held ones against their bounds.
    Returns the launches by design."""
    total = {}
    for i, (label, args, jax_bounds) in enumerate(table[name]):
        result, _, by_design, ws = cli_run(label, args)
        merge_launches(total, by_design)
        if i == 0:
            check(label, result, by_design, ws)
        if jax_bounds is not None:
            vs_jax(label, result, jax_bounds, 1e-3)
        del ws
        torch.cuda.empty_cache()
    return total


def check_lshaped(label, result, by_design, ws):
    """Restart windows per Benders iteration (the subproblem solve's and
    the master's), the master's route; both kernels' designs ran."""
    rows = ws.opt.trace
    phase(label, benders_iters=len(rows),
          sub_windows=json.dumps([r["sub_windows"] for r in rows]),
          master_windows=json.dumps([r["master_windows"] for r in rows]),
          s_per_benders_iter=round((ws.spcomm.trace[-1]["t"]
                                    - ws.spcomm._t0) / max(1, len(rows)),
                                   3),
          master_route=plan_line(empty_master_qp(ws.opt), 1),
          spokes=",".join(type(sp).__name__ for sp in ws.spcomm.spokes))
    if not (rows and all(r["sub_windows"] > 0 for r in rows)
            and by_design.get("pdhg_window/f32/resident", 0) > 0
            and by_design.get("pdhg_window/f32/streamed", 0) > 0):
        raise AssertionError(f"{label}: the subproblems or the master did "
                             "not run their windows in the kernel")
    if ws.opt.options.sub_pdhg.telemetry:   # --kernel-counters
        lane_counters(label, ws)


def lane_counters(label, ws):
    """--kernel-counters on the L-shaped hub: the last subproblem solve's
    per-lane PDHG iterations (min, median, max, lanes at the solve's
    iteration cap), the kernel-counters event's totals (mirrored in the
    metrics registry), and device kernels per restart window of that
    subproblem batch with the counters on and off (torch.profiler)."""
    import dataclasses

    import numpy as np

    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.telemetry import counters as kcounters
    from mpisppy_tpu_torch.telemetry import metrics
    ls = ws.opt
    st, opts = ls.sub_state, ls.options.sub_pdhg
    lanes = kcounters.per_lane(st)
    if lanes is None:
        raise AssertionError(f"{label}: --kernel-counters armed no counters")
    iters = lanes["iters"][ls.batch.p.cpu().numpy() > 0]
    cap = opts.max_iters
    at_cap = np.nonzero(iters >= cap)[0]
    qp = ls.batch.with_fixed_nonants(torch.as_tensor(
        ls.xhat, dtype=ls.batch.qp.c.dtype, device=ls.batch.device))
    off = dataclasses.replace(opts, telemetry=False)
    k_on = count_launches(lambda: pdhg._window(qp, st, opts), 5)
    k_off = count_launches(lambda: pdhg._window(
        qp, dataclasses.replace(st, counters=None), off), 5)
    phase(label + "_counters", lanes=iters.size,
          iters_min=int(iters.min()), iters_median=float(np.median(iters)),
          iters_max=int(iters.max()), cap=cap, lanes_at_cap=at_cap.size,
          lanes_at_cap_ids=json.dumps(at_cap[:16].tolist()),
          restarts_median=float(np.median(lanes["restarts"])),
          event_iterations_total=metrics.REGISTRY.get(
              "pdhg_iterations_total", cyl="hub"),
          event_windows_total=metrics.REGISTRY.get(
              "pdhg_windows_total", cyl="hub"),
          kernels_per_window_on=k_on, kernels_per_window_off=k_off)
    if not (iters.max() > 0 and k_on >= k_off):
        raise AssertionError(f"{label}: counters empty, or fewer kernels "
                             "with the counters on")


def empty_master_qp(ls):
    """The master BoxQP of an L-shaped method at an empty cut buffer."""
    import numpy as np
    n_eta = ls.batch.num_scenarios if ls.options.multicut else 1
    A = np.zeros((ls.options.max_cuts, ls._N + n_eta))
    bl = np.full(ls.options.max_cuts, -np.inf)
    return ls._master_qp(A, bl, -bl, 0.0)[0]


def check_aph(label, result, by_design, ws):
    """The APH hub, its prox windows in K2 (bf16x3), half the scenarios
    dispatched in the last iteration."""
    import numpy as np
    st = ws.opt.state
    last = st.last_solved.cpu().numpy()
    half = int(np.ceil(0.5 * ws.opt.batch.num_real))
    phase(label, hub=type(ws.spcomm).__name__, theta=float(st.theta),
          conv=float(st.conv),
          dispatched_last_iter=int((last == int(st.it)).sum()),
          never_dispatched=int((last == 0).sum()),
          s_per_hub_iter=round((ws.spcomm.trace[-1]["t"] - ws.spcomm._t0)
                               / max(1, result["iterations"]), 3))
    if not (type(ws.spcomm).__name__ == "APHHub"
            and by_design.get("pdhg_window/bf16x3/resident", 0) > 0
            and int((last == int(st.it)).sum()) == half):
        raise AssertionError(f"{label}: not the APH hub, no K2 (bf16x3) "
                             "window, or not half dispatched")


def check_bound_spokes(label, result, by_design, ws):
    """Every outer spoke certified a bound at or below the inner bound."""
    inner = ws.BestInnerBound
    outer = {type(sp).__name__: sp.bound for sp in ws.spcomm.spokes
             if type(sp).__name__ != "XhatXbarInnerBound"}
    rc = next(sp for sp in ws.spcomm.spokes
              if type(sp).__name__ == "ReducedCostsSpoke")
    phase(label, spoke_bounds=json.dumps(outer).replace(" ", ""),
          inner=inner, rc_finite=int(0 if rc.rc_global is None
                                     else (rc.rc_global == rc.rc_global)
                                     .sum()))
    if len(outer) != 4 or not all(
            b is not None and b <= inner + HUB_BOUND_SLACK
            * max(1.0, abs(inner)) for b in outer.values()):
        raise AssertionError(f"{label}: an outer spoke certified no bound, "
                             "or one above the inner bound")


def check_cross_scen(label, result, by_design, ws):
    """Cuts installed, the PH batch is the row-augmented view, its route
    a kernel design that ran."""
    ext = ws.opt.extobject
    qp = ws.opt.batch.qp
    phase(label, cuts_installed=ext.cuts_installed,
          rounds=ext.meta.rounds_used, m_orig=ext.meta.m_orig, m=qp.m,
          n=qp.n, route=plan_line(qp, ws.opt.batch.num_scenarios),
          ob_char=ws.spcomm.latest_ob_char)
    if not (ext.cuts_installed > 0 and qp.m == ext.meta.aug_ph.qp.m
            and by_design.get("pdhg_window/f32/streamed", 0) > 0):
        raise AssertionError(f"{label}: no cuts installed, or the "
                             "augmented view's windows not in the kernel")


CHECKS = {"lshaped_hub": check_lshaped, "aph_hub": check_aph,
          "bound_spokes": check_bound_spokes, "cross_scen": check_cross_scen}


def ccopf_fused_phase():
    """[cli_ccopf_fused]: ccopf (3,3) --soc through --fused-wheel
    --xhatxbar: the x̄ spoke is EFXhatInnerBound, whose root-fixed EF
    runs as one conic problem in the SOC window kernel (its route
    printed); against the JAX CLI at 1e-4 (converged iterates)."""
    result, _, by_design, ws = cli_run("cli_ccopf_fused", CLI_CCOPF_FUSED,
                                       kernel="pdhg_window_soc")
    ef = next(sp for sp in ws.spcomm.spokes
              if type(sp).__name__ == "EFXhatInnerBound")
    phase("cli_ccopf_fused",
          spokes=",".join(type(sp).__name__ for sp in ws.spcomm.spokes),
          ef_m=ef._qp.m, ef_n=ef._qp.n, ef_route=plan_line(ef._qp, 1))
    vs_jax("cli_ccopf_fused", result, CLI_CCOPF_FUSED_JAX_BOUNDS, 1e-4)
    # [slice9_windows]: the root-fixed EF at the spoke's last candidate,
    # two cold windows in, held against its plain version
    import dataclasses
    import types
    xs = ef._frozen.repeat(len(ef.efp.probs)) / ef._dcols
    l, u = ef._qp.l.clone(), ef._qp.u.clone()  # noqa: E741
    l[..., ef._cols], u[..., ef._cols] = xs, xs
    qp = dataclasses.replace(ef._qp, l=l, u=u)
    held_window("ef_root_fixed", qp, window_inputs(
        types.SimpleNamespace(qp=qp), done_every=0), soc=True)
    return by_design


def sc_phase(dev):
    """[sc]: SchurComplement on sslp 5x15 LP relaxation at SC_SCENS in
    f64 on the card, against scipy HiGHS on algos/ef.py's extensive
    form (SC_REL_TOL)."""
    from mpisppy_tpu_torch.algos.sc import SchurComplement, SCOptions
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import sslp
    inst = sslp.synthetic_instance(5, 15, seed=0)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=SC_SCENS,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(SC_SCENS)]
    sc = SchurComplement(SCOptions(max_iter=250, tol=SC_TOL),
                         batch_mod.from_specs(specs, device=dev))
    res = sc.solve()
    ref = ef_oracle(specs)
    rel = abs(res["objective"] - ref) / abs(ref)
    phase("sc", S=SC_SCENS, backend=res["backend_used"],
          dtype=str(res["x"].dtype), objective=res["objective"],
          highs_ef=ref, rel_diff=rel, tol=SC_REL_TOL,
          converged=res["converged"], mu=res["mu"], resid=res["resid"],
          solve_s=res["solve_seconds"])
    if not (res["backend_used"] == "cuda" and res["converged"]
            and rel <= SC_REL_TOL):
        raise AssertionError("sc: not on the card, not converged, or off "
                             "the HiGHS EF optimum")


def cli_capped(args, flag, value):
    """`args` with the value of `flag` replaced."""
    a = list(args)
    a[a.index(flag) + 1] = str(value)
    return a


def slice9_profile(dev):
    """[slice9_profile]: profile_wheel over the L-shaped hub at
    LSHAPED_SCENS capped at one Benders iteration and the APH hub at
    APH_SCENS capped at one hub iteration after iter0 (device busy
    share, window share, top kernels)."""
    import contextlib
    import io

    from mpisppy_tpu_torch import generic_cylinders

    def runner(args):
        def run():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                ws = generic_cylinders.main(list(args))
            torch.cuda.synchronize()
            return ws, time.perf_counter() - t0
        return run
    import types
    for label, S, args in (
            ("lshaped_profile", LSHAPED_SCENS,
             cli_capped(slice9_table(True)["lshaped_hub"][0][1],
                        "--lshaped-max-iter", 1)),
            ("aph_profile", APH_SCENS,
             cli_capped(slice9_table(True)["aph_hub"][0][1],
                        "--max-iterations",
                        1))):
        profile_wheel(label, types.SimpleNamespace(num_scenarios=S),
                      runner(args))
        torch.cuda.empty_cache()


def slice9_path(dev, full=False):
    """The decomposition hubs and bound spokes: [slice9_windows], then
    each new path through the CLI (slice9_table(full)).
    Returns the window parity errors and the launches by design over
    the main paths."""
    t0 = time.perf_counter()
    errs = slice9_windows(dev)
    total = {}
    for name, check in CHECKS.items():
        merge_launches(total, slice9_runs(slice9_table(full), name,
                                          check))
    merge_launches(total, ccopf_fused_phase())
    sc_phase(dev)
    phase("slice9_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return errs, total


class EventProbe:
    """A telemetry sink keeping the data of the events of some kinds."""

    def __init__(self, *kinds):
        self.kinds, self.seen = kinds, []

    def handle(self, e):
        if e.kind in self.kinds:
            self.seen.append((e.kind, dict(e.data)))

    def close(self):
        pass

    def of(self, kind):
        return [d for k, d in self.seen if k == kind]


class ProfileIters:
    """PH extension: torch.profiler (host and device) over hub
    iterations [first, first + count): wall per iteration, the device
    busy share, and the host time blocked in synchronizing CUDA calls
    (stream/event/device synchronize and the blocking device-to-host
    copies behind a host read of a device value)."""

    BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize",
                "cudaDeviceSynchronize", "cudaMemcpyAsync")

    def __init__(self, opt, first, count, out):
        self.opt, self.first, self.count, self.out = opt, first, count, out
        self.prof = None

    def miditer(self):
        from torch.profiler import ProfilerActivity, profile
        if self.opt._iter == self.first:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()

    def enditer_after_sync(self):
        if self.prof is None \
                or self.opt._iter != self.first + self.count - 1:
            return
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        every, blocked, launches = [], 0.0, 0
        for name, on_device, a, b in recorded_events(self.prof):
            if on_device:
                every.append((a, b))
            elif name in self.BLOCKING:
                blocked += b - a
            elif name == "cudaLaunchKernel":
                launches += 1
        n = self.count
        # the busy share as the package reads it (kernels, memsets and
        # copies), and over every device-side event as PRs 10-11 read it
        # (with the device's copies of the host ranges)
        self.out.update(
            profiled_iters=n, wall_ms_per_iter=round(1e3 * wall / n, 3),
            blocked_ms_per_iter=round(blocked / 1e3 / n, 3),
            blocked_share=round(blocked / (wall * 1e6), 4),
            device_busy_share=round(
                busy_us(device_spans(self.prof)) / (wall * 1e6), 4),
            busy_every_device_event=round(busy_us(every) / (wall * 1e6),
                                          4),
            kernel_launches_per_iter=round(launches / n, 1))
        self.prof = None


def overhead_wheel(batch, opts, staleness, profile_out=None):
    """bench.py's overhead wheel (the four fused spokes, slam 2, shuffle
    4, spoke_period 3; rel_gap 0): the sync pair (staleness None) or the
    async pair.  Returns the spinner, its events and its launches by
    design."""
    import functools

    from mpisppy_tpu_torch import telemetry
    from mpisppy_tpu_torch.algos import async_wheel as aw
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import AsyncPHHub, PHHub
    from mpisppy_tpu_torch.ops import pdhg_window
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    probe = EventProbe("plane-write", "exchange-overlap")
    bus = telemetry.EventBus()
    bus.subscribe(probe)
    hub_opts = {"rel_gap": 0.0, "telemetry_bus": bus}
    hub = {"hub_class": PHHub, "hub_kwargs": {"options": hub_opts},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions(
                              slam_windows=2, shuffle_windows=4,
                              spoke_period=3)}}
    if staleness is not None:
        hub["hub_class"], hub["opt_class"] = AsyncPHHub, aw.AsyncFusedPH
        hub["opt_kwargs"]["async_options"] = aw.AsyncWheelOptions(
            staleness=staleness)
        hub_opts["async_staleness"] = staleness
    if profile_out is not None:
        hub["opt_kwargs"]["extensions"] = functools.partial(
            ProfileIters,
            first=opts.max_iterations - ASYNC_PROFILE_ITERS + 1,
            count=ASYNC_PROFILE_ITERS, out=profile_out)
    spokes = [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        spoke.FusedLagrangianOuterBound, spoke.FusedXhatXbarInnerBound,
        spoke.FusedXhatShuffleInnerBound, spoke.FusedSlamHeuristic)]
    reset_launches()
    ws = WheelSpinner(hub, spokes).spin()
    torch.cuda.synchronize()
    return ws, probe, dict(pdhg_window.run_window.launches_by_design)


def steady_s_per_iter(ws, n_iters):
    """Steady-state seconds per hub iteration from the trace rows of
    iterations 4 to n_iters - ASYNC_PROFILE_ITERS: the median
    (bench.py's; at spoke_period 3 a hub-only iteration) and the mean
    (spoke iterations included)."""
    import statistics
    rows = ws.spcomm.trace
    last = n_iters - ASYNC_PROFILE_ITERS
    diffs = [b["t"] - a["t"] for a, b in zip(rows[3:], rows[4:])
             if b["iter"] <= last]
    return statistics.median(diffs), statistics.mean(diffs)


def bare_ph_s_per_iter(batch, opts, n_iters):
    """Bare PH seconds per iteration (iter0 and one iterk excluded)."""
    from mpisppy_tpu_torch.algos import ph as ph_mod
    rho = torch.full((batch.num_nonants,), opts.default_rho,
                     device=batch.device)
    st, _, _ = ph_mod.ph_iter0(batch, rho, opts)
    st = ph_mod.ph_iterk(batch, st, opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        st = ph_mod.ph_iterk(batch, st, opts)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_iters


def rows_minus_t(ws):
    return [{k: v for k, v in row.items() if k != "t"}
            for row in ws.spcomm.trace]


def async_overhead(dev, full=False):
    """[async_overhead]: bench.py's bench_wheel_overhead_async on the
    card — bare PH, the sync pair, then the async pair at staleness
    0/1/2, each for ASYNC_OVERHEAD_ITERS hub iterations, the sync pair
    and staleness 1 with a profile of two steady iterations.  Staleness 0 must equal the sync pair row for
    row (minus `t`); every plane write must be at most s stale;
    staleness 1/2 must publish a finite outer bound, and an inner bound
    that lands must lie above it (at this depth the x̂ candidate may not
    have landed yet, in the sync pair either).  Returns the launches by
    design of the async runs."""
    import statistics
    n_iters = ASYNC_OVERHEAD_ITERS[full]
    t0 = time.perf_counter()
    batch = sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    build_s = time.perf_counter() - t0
    opts = sslp_options("bf16x3", n_iters, 1e-6, 8)
    bare = bare_ph_s_per_iter(batch, opts, n_iters)
    phase("async_overhead", S=HEADLINE_SCENS, iter_precision="bf16x3",
          hub_iters=n_iters, bare_ph_s_per_iter=round(bare, 5),
          batch_build_s=round(build_s, 2))
    total, rows = {}, {}
    for s in (None, 0, 1, 2):
        prof = {} if s in (None, 1) else None
        t0 = time.perf_counter()
        ws, probe, by_design = overhead_wheel(batch, opts, s, prof)
        wall = time.perf_counter() - t0
        per_iter, mean_iter = steady_s_per_iter(ws, n_iters)
        rows[s] = rows_minus_t(ws)
        writes = probe.of("plane-write")
        overlaps = probe.of("exchange-overlap")
        thetas = [o["theta"] for o in overlaps if "theta" in o]
        fields = {}
        if overlaps:
            fields = dict(
                issue_s_median=round(statistics.median(
                    o["issue_s"] for o in overlaps), 6),
                complete_s_median=round(statistics.median(
                    o["complete_s"] for o in overlaps), 6),
                plane_writes=len(writes),
                plane_staleness_max=max(
                    (w["staleness"] for w in writes), default=None),
                theta_min=min(thetas, default=None),
                theta_max=max(thetas, default=None))
        phase("async_overhead", staleness="sync" if s is None else s,
              s_per_iter=round(per_iter, 5),
              overhead_factor=round(per_iter / bare, 3),
              mean_s_per_iter=round(mean_iter, 5),
              mean_overhead_factor=round(mean_iter / bare, 3),
              outer=ws.BestOuterBound, inner=ws.BestInnerBound,
              wall_s=round(wall, 2),
              by_design=json.dumps(by_design, sort_keys=True)
              .replace(" ", ""), **fields)
        if prof is not None:
            phase("async_overhead_profile",
                  staleness="sync" if s is None else s, **prof)
            if not prof:
                raise AssertionError("async_overhead_profile: the "
                                     "profiled iterations did not run")
        if s is not None:
            merge_launches(total, by_design)
        if any(w["staleness"] > max(1, s or 0) for w in writes):
            raise AssertionError(f"async_overhead: a plane write past "
                                 f"staleness {s}")
        if s in (1, 2) and not (
                math.isfinite(ws.BestOuterBound)
                and ws.BestOuterBound <= ws.BestInnerBound):
            raise AssertionError(f"async_overhead: staleness {s} outer "
                                 "bound not finite, or bounds crossed")
        if s in (1, 2) and len(writes) != n_iters:
            raise AssertionError("async_overhead: not one plane write "
                                 "per iterk")
        del ws
    same = rows[0] == rows[None]
    phase("async_overhead", staleness0_rows_equal_sync=same,
          rows=len(rows[0]))
    if not same:
        raise AssertionError("async_overhead: staleness 0 differs from "
                             "the sync pair")
    del batch
    torch.cuda.empty_cache()
    return total


def async_headline(sync, full=False):
    """[async_headline]: the headline CLI flags with --async-staleness 1
    and --trace-jsonl, S=10,000, for ASYNC_HEADLINE_ITERS hub iterations
    (with `full` to a 1% certificate, at most HEADLINE_MAX_ITERS),
    beside the sync headline's iterations and seconds from
    [cli_headline] in the same run.  The trace holds one run-start and
    one run-end, and a plane-write and an exchange-overlap per iterk."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "async_headline.jsonl")
        result, _, by_design, ws = cli_run(
            "async_headline", cli_capped(
                CLI_ASYNC_HEADLINE, "--max-iterations",
                ASYNC_HEADLINE_ITERS[full]) + ["--trace-jsonl", path])
        with open(path) as f:
            kinds = [json.loads(line)["kind"] for line in f]
    iters = result["iterations"]
    count = {k: kinds.count(k) for k in ("run-start", "run-end",
                                         "plane-write", "exchange-overlap")}
    ref = sync.get("cli_headline")
    phase("async_headline", hub=type(ws.spcomm).__name__,
          iterations=iters, seconds=round(result["wall_s"], 2),
          rel_gap=result["rel_gap"],
          sync_iterations=None if ref is None else ref["iterations"],
          sync_seconds=None if ref is None else round(ref["wall_s"], 2),
          trace_events=len(kinds), **{k.replace("-", "_"): v
                                      for k, v in count.items()})
    if not ((result["rel_gap"] <= 0.01 or not full)
            and type(ws.spcomm).__name__ == "AsyncPHHub"
            and count["run-start"] == count["run-end"] == 1
            and count["plane-write"] == iters - 1
            and count["exchange-overlap"] == iters):
        raise AssertionError("async_headline: no 1% certificate (--full), "
                             "not the async hub, or the trace is short of "
                             "events")
    qp = ws.opt.batch.qp
    check_designs("async_headline", by_design, qp.m, qp.n,
                  (HEADLINE_SCENS, TAIL_SCENS))
    return by_design


def held_with_faults(args):
    """The [async_held] command built as the CLI builds it, with a
    FaultPlan of one dropped plane write and one torn swap in the hub's
    options.  Returns the spinner, its plane-write events, the plan and
    the launches by design."""
    import importlib

    from mpisppy_tpu_torch import dispatch, telemetry
    from mpisppy_tpu_torch import generic_cylinders as gc
    from mpisppy_tpu_torch.ops import pdhg_window
    from mpisppy_tpu_torch.resilience import AsyncExchangeFault, FaultPlan
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    module = importlib.import_module("mpisppy_tpu_torch.models.sslp")
    cfg = gc._parse_args(module, args)
    hub, spokes, _, _, _ = gc.build_wheel(cfg, module)
    plan = FaultPlan(seed=11, exchanges=(
        AsyncExchangeFault("drop_plane_write", at_iters=(3,)),
        AsyncExchangeFault("torn_swap", at_iters=(6,))))
    probe = EventProbe("plane-write")
    bus = telemetry.EventBus()
    bus.subscribe(probe)
    hub["hub_kwargs"]["options"].update(fault_plan=plan, telemetry_bus=bus)
    dispatch.from_cfg(cfg)
    reset_launches()
    ws = WheelSpinner(hub, spokes).spin()
    torch.cuda.synchronize()
    return ws, probe.of("plane-write"), plan, \
        dict(pdhg_window.run_window.launches_by_design)


def async_held(full=False):
    """[async_held]: the README's sslp command (5x25, S=100) with
    --fused-wheel --async-staleness 1 for ASYNC_HELD_ITERS hub
    iterations against the JAX CLI's bounds, then the same run with a
    dropped plane write and a torn swap: plane writes past the bound,
    and finite ordered bounds still."""
    n = ASYNC_HELD_ITERS[full]
    args = CLI_ASYNC_HELD + ["--max-iterations", str(n)]
    result, _, total, _ = cli_run("async_held", args)
    vs_jax("async_held", result, ASYNC_HELD_JAX_BOUNDS[n], 1e-3)
    ws, writes, plan, by_design = held_with_faults(args)
    merge_launches(total, by_design)
    stal = [w["staleness"] for w in writes]
    fired = sorted({d.split()[0] for seam, d in plan.fired
                    if seam == "exchange"})
    phase("async_held_faults", fired=",".join(fired),
          plane_writes=len(writes), staleness_max=max(stal),
          staleness=json.dumps(stal).replace(" ", ""),
          outer=ws.BestOuterBound, inner=ws.BestInnerBound)
    if not (fired == ["drop_plane_write", "torn_swap"] and max(stal) > 1
            and math.isfinite(ws.BestOuterBound)
            and math.isfinite(ws.BestInnerBound)
            and ws.BestOuterBound <= ws.BestInnerBound):
        raise AssertionError("async_held: the faults did not show, or the "
                             "bounds are not finite and ordered")
    return total


def async_ccopf(dev, sync):
    """[async_ccopf]: the ccopf --soc (100,100) wheel at S=10,000, f32,
    staleness 1, to its gap or ASYNC_CCOPF_MAX_ITERS hub iterations, on
    the resident SOC kernel; its bounds within the hub's bound_slack of
    the sync ccopf wheel's from [ccopf_soc] (run here when that phase
    did not)."""
    batch = ccopf_batch(CCOPF_BFS, dev)
    if "ccopf_soc" not in sync:
        ws, _ = wheel(batch, ccopf_options())
        sync["ccopf_soc"] = (ws.BestOuterBound, ws.BestInnerBound)
        del ws
    ws, _, by_design = main_wheel(
        "async_ccopf", "pdhg_window_soc", batch,
        ccopf_options(ASYNC_CCOPF_MAX_ITERS), slack=HUB_BOUND_SLACK,
        staleness=1, model="ccopf_soc", bfs="x".join(map(str, CCOPF_BFS)),
        iter_precision="f32")
    check_soc_designs("async_ccopf", by_design)
    ref = sync["ccopf_soc"]
    diff = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(
        (ws.BestOuterBound, ws.BestInnerBound), ref))
    phase("async_ccopf", sync_outer=ref[0], sync_inner=ref[1],
          max_rel_diff_vs_sync=diff, bound_slack=HUB_BOUND_SLACK)
    if diff > HUB_BOUND_SLACK:
        raise AssertionError("async_ccopf: bounds off the sync wheel's")
    del ws, batch
    torch.cuda.empty_cache()
    return by_design


def async_path(dev, sync, full=False):
    """The async wheel's four phases, compared with the sync results in
    `sync` (filled by cli_path and ccopf_path); returns their main runs'
    launches by design (K1, K2 and the resident SOC kernel)."""
    t0 = time.perf_counter()
    total = async_overhead(dev, full)
    merge_launches(total, async_headline(sync, full))
    torch.cuda.empty_cache()
    merge_launches(total, async_held(full))
    merge_launches(total, async_ccopf(dev, sync))
    phase("async_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return total


def checkpoint_headline(dev, sync):
    """[checkpoint_headline]: the headline wheel ([headline]'s batch and
    options) with checkpoints: background saves every CKPT_EVERY_S
    seconds and a fault plan that preempts it at hub iteration
    CKPT_PREEMPT_AT, whose emergency save the spinner writes; then a
    freshly built wheel restores the newest snapshot and resumes to 1%
    (at most HEADLINE_MAX_ITERS).  Prints the snapshot's bytes and
    leaves, the background saves (each re-read and CRC-checked), the
    emergency save's and the restore's seconds, seconds per hub
    iteration before the preemption against [headline]'s over the same
    rows (the background writes' cost), iterations to 1%, and the final
    bounds against [headline]'s (held at 1e-3 relative), and whether the
    resumed rows equal [headline]'s (the snapshot's extras carry the
    fused wheel's host step cycle) or the first that differs.  Returns
    the launches by design of both runs."""
    import os
    import tempfile

    import numpy as np

    from mpisppy_tpu_torch import telemetry as tel
    from mpisppy_tpu_torch.ops import pdhg_window
    from mpisppy_tpu_torch.resilience.faults import (
        FaultPlan, SimulatedPreemption,
    )
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    if "headline" not in sync:      # --only: the uninterrupted run first
        headline(sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS,
                            dev), sync)
    ref = sync["headline"]
    batch = ref["batch"]
    opts = sslp_options("bf16x3", HEADLINE_MAX_ITERS, 1e-6, 8)
    total = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "headline.npz")
        writes = []     # (hub_iter, bytes) of every snapshot written

        class Writes:
            def handle(self, e):
                if e.kind == "checkpoint-write":
                    writes.append((e.hub_iter, e.data["bytes"]))

            def close(self):
                pass
        bus = tel.EventBus()
        bus.subscribe(Writes())
        extra = {"checkpoint_path": path, "checkpoint_every_s": CKPT_EVERY_S,
                 "checkpoint_keep": CKPT_KEEP, "telemetry_bus": bus,
                 "fault_plan": FaultPlan(seed=0,
                                         preempt_at_iter=CKPT_PREEMPT_AT)}
        reset_launches()
        ws = WheelSpinner(*wheel_dicts(batch, opts, hub_extra=extra)).build()
        hub = ws.spcomm
        save = {}
        real_save = hub.emergency_checkpoint

        def timed_save(p):
            t0 = time.perf_counter()
            ok = real_save(p)
            save["s"] = time.perf_counter() - t0
            return ok
        hub.emergency_checkpoint = timed_save
        try:
            ws.spin()
            raise AssertionError("checkpoint_headline: the fault plan "
                                 "never preempted the wheel")
        except SimulatedPreemption:
            pass
        merge_launches(total, pdhg_window.run_window.launches_by_design)
        if getattr(hub, "_ckpt_thread", None) is not None:
            hub._ckpt_thread.join()
        before = trace_rows(ws)
        checked = {}     # hub_iter -> (bytes, leaves) of every file
        for cand in hub._checkpoint_candidates(path):
            arrays = hub._read_checkpoint_arrays(cand)   # CRC checked
            checked[int(arrays["hub_iter"])] = (
                os.path.getsize(cand),
                sum(1 for k in arrays if k.startswith("leaf")))
        # the newest by hub_iter is the emergency save's (a background
        # write landing after it may hold `path` itself)
        snap_iter = max(checked)
        nbytes, leaves = checked[snap_iter]
        background = [it for it, _ in writes if it != snap_iter]
        del arrays
        del ws, hub
        torch.cuda.empty_cache()

        reset_launches()
        ws2 = WheelSpinner(*wheel_dicts(batch, opts, hub_extra={
            "checkpoint_path": path, "checkpoint_every_s": 1e9})).build()
        t0 = time.perf_counter()
        ws2.spcomm.load_checkpoint(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ws2.spin()
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        merge_launches(total, pdhg_window.run_window.launches_by_design)
    after = trace_rows(ws2)

    def s_per_iter(rows):
        r = [row for row in rows if 2 <= row["iter"] < CKPT_PREEMPT_AT]
        return (r[-1]["t"] - r[0]["t"]) / (r[-1]["iter"] - r[0]["iter"])

    keys = ("iter", "conv", "outer", "inner")
    by_iter = {r["iter"]: r for r in ref["rows"]}
    differ = next((r for r in after if r["iter"] not in by_iter
                   or any(r[k] != by_iter[r["iter"]][k] for k in keys)),
                  None)
    outer, inner = ws2.BestOuterBound, ws2.BestInnerBound
    rel_gap = ws2.spcomm.compute_gaps()[1]
    rel = max(abs(outer - ref["bounds"][0]) / abs(ref["bounds"][0]),
              abs(inner - ref["bounds"][1]) / abs(ref["bounds"][1]))
    phase("checkpoint_headline", S=batch.num_scenarios,
          snapshot_bytes=nbytes, snapshot_leaves=leaves,
          snapshot_hub_iter=snap_iter,
          background_saves=len(background),
          background_save_iters=json.dumps(background),
          crc_checked_iters=json.dumps(sorted(checked)),
          background_save_bytes=json.dumps(
              [b for it, b in writes if it != snap_iter]),
          emergency_save_s=round(save["s"], 3), restore_s=round(restore_s, 3),
          s_per_iter_with_saves=round(s_per_iter(before), 5),
          s_per_iter_headline=round(s_per_iter(ref["rows"]), 5),
          resumed_first_iter=after[0]["iter"],
          iterations_to_1pct=ws2.spcomm._iter,
          headline_iterations=ref["iterations"], resume_s=round(resume_s, 2),
          outer=outer, inner=inner, rel_gap=rel_gap,
          headline_outer=ref["bounds"][0], headline_inner=ref["bounds"][1],
          max_rel_diff_vs_headline=rel, tol=1e-3)
    if differ is None:
        phase("checkpoint_headline", resumed_rows="equal to [headline]'s")
    else:
        want = by_iter.get(differ["iter"], {})
        phase("checkpoint_headline", first_differing_row=differ["iter"],
              resumed=json.dumps({k: differ[k] for k in keys[1:]}),
              headline=json.dumps({k: want.get(k) for k in keys[1:]}))
    if not (snap_iter == CKPT_PREEMPT_AT and background
            and sorted(checked) == sorted(it for it, _ in writes)
            and after[0]["iter"] == snap_iter + 1
            and rel_gap <= 0.01 and rel <= 1e-3):
        raise AssertionError("checkpoint_headline: wrong snapshot, no "
                             "background save, no 1% certificate after the "
                             "resume, or bounds off [headline]'s")
    return total


def preempt_cli():
    """[preempt_cli]: the README's sslp command through `python -m
    mpisppy_tpu_torch` in a subprocess with --checkpoint-path (and
    --trace-jsonl), sent a real SIGTERM once its trace shows hub
    iteration PREEMPT_CLI_AT: it must exit 75 with the preempted line.
    Rerun with --checkpoint-restore, capped two PH iterations past the
    snapshot's: rc 0 and its trace's first iteration the snapshot's
    hub_iter + 1.  The same command runs uninterrupted to the same cap
    beside the rerun, and the resumed trace rows are held to its rows:
    conv and the inner bound on every row at 1e-6 relative, the outer
    bound from the second row on at 1e-5.  The classic Lagrangian
    spoke's bound in flight and its warm start are not in the snapshot,
    in the JAX package neither: the first resumed row shows the bound
    before it, and the cold solves land ~5e-7 apart (the CPU), against
    ~3e-4 that the outer bound moves in an iteration.  The rows align
    at the snapshot's hub_iter + 1, or at + 2 when the signal landed
    after the state of the PH step in progress had been assigned but
    before its sync (the snapshot then holds that step's state under
    the same counters; the JAX package's emergency save does the same,
    ROADMAP.md C6).  A restart from a fresh state or a neighbouring
    iteration's moves conv by 1e-3 relative here."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mpisppy_tpu_torch", *README_SSLP]

    def rows(path):
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line)["data"] for line in f
                    if '"hub-iteration"' in line]

    def close(a, b, tol=1e-6):
        return a == b or (a is not None and b is not None
                          and abs(a - b) <= tol * abs(b))

    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "readme.npz")
        t1, t2, t3 = (os.path.join(d, f"t{i}.jsonl") for i in (1, 2, 3))
        with open(os.path.join(d, "err1"), "w") as err:
            t0 = time.perf_counter()
            p = subprocess.Popen(
                cmd + ["--max-iterations", str(PREEMPT_CLI_CAP),
                       "--checkpoint-path", ckpt, "--trace-jsonl", t1,
                       "--flight-dir", d],
                cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
            try:
                while p.poll() is None and not any(
                        r["iter"] >= PREEMPT_CLI_AT for r in rows(t1)):
                    time.sleep(0.05)
                seen = max((r["iter"] for r in rows(t1)), default=0)
                p.send_signal(signal.SIGTERM)
                out, _ = p.communicate(timeout=600)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            first_s = time.perf_counter() - t0
        line = json.loads(out.strip().splitlines()[-1])
        with np.load(ckpt) as z:
            hub_iter, opt_iter = int(z["hub_iter"]), int(z["opt_iter"])
        cap = ["--max-iterations", str(opt_iter + 2)]
        t0 = time.perf_counter()
        runs = (["--checkpoint-path", ckpt, "--checkpoint-restore",
                 "--trace-jsonl", t2], ["--trace-jsonl", t3])
        procs, errs = [], []
        try:
            for i, extra in enumerate(runs):
                errs.append(os.path.join(d, f"err{i + 2}"))
                with open(errs[-1], "w") as e:
                    procs.append(subprocess.Popen(
                        cmd + cap + extra, cwd=root,
                        stdout=subprocess.DEVNULL, stderr=e))
            for proc in procs:
                proc.wait(timeout=900)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        q, plain = procs
        second_s = time.perf_counter() - t0
        resumed, ref = rows(t2), rows(t3)
        err1, q_err, plain_err = (
            Path(f).read_text() for f in [os.path.join(d, "err1"), *errs])
    by_iter = {r["iter"]: r for r in ref}

    def held(shift):
        """The resumed rows equal the uninterrupted rows `shift` later."""
        want = [by_iter.get(r["iter"] + shift) for r in resumed]
        return bool(resumed) and all(
            w is not None and close(r["conv"], w["conv"])
            and close(r["inner"], w["inner"])
            and (j == 0 or close(r["outer"], w["outer"], 1e-5))
            for j, (r, w) in enumerate(zip(resumed, want)))

    shift = next((k for k in (0, 1) if held(k)), None)
    keys = ("iter", "conv", "outer", "inner")
    phase("preempt_cli", signal_after_iter=seen, rc=p.returncode,
          preempted_line=json.dumps(line).replace(" ", ""),
          snapshot_hub_iter=hub_iter, snapshot_opt_iter=opt_iter,
          first_run_s=round(first_s, 2), restore_rc=q.returncode,
          resumed_iters=json.dumps([r["iter"] for r in resumed]),
          second_run_s=round(second_s, 2), cap=opt_iter + 2,
          uninterrupted_rc=plain.returncode, rows_held_at_shift=shift,
          tol_conv_inner=1e-6, tol_outer=1e-5)
    for r in resumed:
        w = by_iter.get(r["iter"] + (shift or 0), {})
        phase("preempt_cli", row=r["iter"],
              resumed=json.dumps({k: r.get(k) for k in keys[1:]}),
              uninterrupted=json.dumps({k: w.get(k) for k in keys}))
    if not (p.returncode == 75 and line.get("preempted") is True
            and line.get("checkpoint_path") == ckpt
            and "emergency checkpoint written" in err1
            and q.returncode == 0 and plain.returncode == 0
            and len(resumed) >= 2 and resumed[0]["iter"] == hub_iter + 1
            and shift is not None):
        raise AssertionError(
            f"preempt_cli: no exit 75 with a preempted line and a save, or "
            f"the restore did not resume at hub_iter + 1 on the "
            f"uninterrupted run's rows (stderr of the restore: "
            f"{q_err[-2000:]}; of the uninterrupted run: "
            f"{plain_err[-2000:]})")


def hub_iteration_seconds(trace):
    """{k: seconds of hub iteration k} from a --trace-jsonl file: the
    gap between the hub-iteration events of syncs k-1 and k."""
    with open(trace) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    t = {r["iter"]: r["t_mono"] for r in rows if r["kind"] == "hub-iteration"}
    return {k: t[k] - t[k - 1] for k in sorted(t) if k - 1 in t}


def profile_cli():
    """[profile_cli]: the headline's CLI flags (sslp 15x45, S=10,000,
    bf16x3, four fused spokes) capped at PROFILE_CLI_ITERS hub iterations
    with --profile-dir D --profile-iters PROFILE_CLI_WINDOW --trace-jsonl
    T, then `python -m mpisppy_tpu_torch.telemetry analyze --trace-jsonl
    T` in a subprocess, as a user runs it, and `gate D/device_profile.json
    D/device_profile.json` through the same module's main().  Fails
    unless the capture lies under D/plugins/profile/ with a `captured`
    event in T naming it, the report parses with no
    share of a peak above 1.0 and device activity in it, it lists K2 with
    a launch, and both commands exit 0.  Prints the export's cost, the
    seconds per hub iteration before, inside and after the window, the
    busy share and K2's ms per launch.  Returns the launches by design."""
    import contextlib
    import io
    import os
    import tempfile

    from mpisppy_tpu_torch.telemetry import deviceprof, roofline
    from mpisppy_tpu_torch.telemetry.__main__ import main as telemetry_main
    here = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "mpisppy_tpu_torch.telemetry"]
    with tempfile.TemporaryDirectory() as d:
        prof, trace = os.path.join(d, "prof"), os.path.join(d, "t.jsonl")
        result, _, by_design, ws = cli_run("profile_cli", cli_capped(
            CLI_HEADLINE, "--max-iterations", PROFILE_CLI_ITERS) + [
            "--profile-dir", prof, "--profile-iters",
            str(PROFILE_CLI_WINDOW), "--trace-jsonl", trace])
        sess = ws.spcomm._profiler
        del ws
        torch.cuda.empty_cache()
        caps = deviceprof.discover_captures(prof)
        with open(trace) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
        captured = [e["data"].get("trace_dir") for e in events
                    if e["kind"] == "profile"
                    and e["data"].get("action") == "captured"]
        rep_path = os.path.join(prof, "device_profile.json")
        with open(rep_path) as f:
            rep = json.load(f)
        t0 = time.perf_counter()
        an = subprocess.run(cli + ["analyze", "--trace-jsonl", trace],
                            capture_output=True, text=True, cwd=here,
                            timeout=600)
        analyze_s = time.perf_counter() - t0
        gate_out = io.StringIO()
        with contextlib.redirect_stdout(gate_out):
            gate_rc = telemetry_main(["gate", rep_path, rep_path])
        secs = hub_iteration_seconds(trace)
    first = sess.start_iter
    last = first + sess.num_iters
    # hub iteration k runs from sync k-1's event to sync k's: the window
    # opens in sync `first` and closes (export included) in sync `last`
    inside = {k: v for k, v in secs.items() if first < k <= last}
    if last in inside and sess.stop_s is not None:
        inside[last] -= sess.stop_s
    before = {k: v for k, v in secs.items() if k <= first}
    if first in before and sess.start_s is not None:
        before[first] -= sess.start_s

    def med(v):
        v = sorted(v)
        return round(v[len(v) // 2], 4) if v else None
    k2 = (rep.get("kernels") or {}).get(K2_KEY, {})
    shares = roofline.peak_shares(rep)
    phase("profile_cli", capture=f"'{caps[-1]['trace'] if caps else None}'",
          start_s=None if sess.start_s is None else round(sess.start_s, 3),
          export_s=None if sess.export_s is None else round(sess.export_s, 3),
          stop_s=None if sess.stop_s is None else round(sess.stop_s, 3),
          trace_bytes=sess.trace_bytes, window=f"[{first},{last})",
          s_per_iter=json.dumps({k: round(v, 4) for k, v in
                                 secs.items()}).replace(" ", ""),
          before_s_per_iter=med(before.values()),
          inside_s_per_iter=med(inside.values()),
          after_s_per_iter=med(v for k, v in secs.items() if k > last),
          busy_share=rep.get("busy_share"),
          device_sec_per_iter=rep.get("device_sec_per_iter"),
          k2_launches=k2.get("launches"),
          k2_ms_per_launch=k2.get("ms_per_launch"),
          k2_roofline_frac=k2.get("roofline_frac"),
          peak_shares=json.dumps(shares).replace(" ", ""),
          card=f"'{rep.get('device')}, {rep.get('power_limit')}'",
          analyze_rc=an.returncode, analyze_s=round(analyze_s, 2),
          gate_rc=gate_rc)
    for ln in an.stdout.splitlines():
        if ln.strip().startswith(("device", "pdhg_window", "steps:")):
            phase("profile_cli", analyze=f"'{ln.strip()[:150]}'")
    problems = []
    if sess.failed or not caps or len(caps) != 1:
        problems.append("the profiler failed or left no single capture")
    elif os.path.dirname(caps[0]["dir"]) != os.path.join(
            prof, "plugins", "profile") or captured != [caps[0]["dir"]]:
        problems.append("the capture is not under D/plugins/profile/<ts>/ "
                        "or no `captured` event names it")
    if not rep.get("busy_share") or not rep.get("kernels"):
        problems.append("the capture holds no device activity")
    if any(v > 1.0 for v in shares.values()):
        problems.append(f"a share of a peak reads above 1.0: {shares}")
    if not k2.get("launches"):
        problems.append("the device report lists no K2 launch")
    if an.returncode != 0 or K2_KEY not in an.stdout:
        problems.append(f"analyze exited {an.returncode} or printed no "
                        f"device section naming K2: {an.stderr[-2000:]}")
    if gate_rc != 0:
        problems.append(f"gate exited {gate_rc}: "
                        f"{gate_out.getvalue()[-2000:]}")
    if problems:
        raise AssertionError("profile_cli: " + "; ".join(problems))
    return by_design


def resilience_path(dev, sync):
    """The checkpoint and preemption phases.  Returns the launches by
    design of [checkpoint_headline]."""
    t0 = time.perf_counter()
    total = checkpoint_headline(dev, sync)
    torch.cuda.empty_cache()
    preempt_cli()
    phase("resilience_path", seconds=round(time.perf_counter() - t0, 2))
    return total


def credit(kernels, by_design):
    """Add main-path launches (by instantiation/mode/design) to the
    kernels line's entries: resident box bf16x3 -> K2, resident box f32
    -> K1, streamed box -> the streamed entry, SOC by design."""
    names = {e["name"]: e for e in kernels}
    for key, count in by_design.items():
        inst, mode, design = key.split("/")
        if inst == "pdhg_window" and design == "resident":
            name = "pdhg_window" if mode == "bf16x3" else "pdhg_window_f32"
        elif inst == "pdhg_window":
            name = "pdhg_window_streamed"
        elif inst == "pdhg_window_soc":
            name = "pdhg_window_soc" if design == "resident" \
                else "pdhg_window_soc_streamed"
        else:
            name = inst
        names[name]["launches"] += count


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from mpisppy_tpu_torch.ops import pdhg_window
    from mpisppy_tpu_torch.telemetry import roofline

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # the card, and whether the bound column has its own peak rates
    phase("card", nvidia_smi=f"'{card_line()}'", torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count(),
          peaks="card" if roofline.peaks_for(kind) else "H100 SXM table")
    print(card_line(), flush=True)

    # build the kernel (every instantiation) from this checkout's sources
    t0 = time.perf_counter()
    log = pdhg_window.build()
    phase("build", sources=",".join(
              str(p.relative_to(pdhg_window.CSRC.parents[1]))
              for p in pdhg_window.SOURCES),
          seconds=round(time.perf_counter() - t0, 2),
          ptxas_registers=registers_by_instantiation(log))

    full = "--full" in sys.argv[1:]
    only = {"headline_profile": headline_profile,
            "ccopf_profile": ccopf_profile,
            "farmer_profile": farmer_profile,
            "uc_wheel_full": uc_wheel_full,
            "uc": uc_path,
            "mip": mip_path,
            "mip_gap": mip_gap,
            "slice9_profile": slice9_profile,
            "slice9_windows": slice9_windows,
            "cli_ccopf_fused": lambda dev: ccopf_fused_phase(),
            "sc": sc_phase,
            "async": lambda dev: async_path(dev, {}, full),
            "async_overhead": lambda dev: async_overhead(dev, full),
            "async_headline": lambda dev: async_headline({}, full),
            "async_held": lambda dev: async_held(full),
            "async_ccopf": lambda dev: async_ccopf(dev, {}),
            "resilience": lambda dev: resilience_path(dev, {}),
            "checkpoint_headline": lambda dev: checkpoint_headline(dev, {}),
            "preempt_cli": lambda dev: preempt_cli(),
            "profile_cli": lambda dev: profile_cli(),
            **{name: (lambda dev, n=name: slice9_runs(
                slice9_table(full), n, CHECKS[n])) for name in CHECKS}}
    if sys.argv[1:2] == ["--only"]:
        for name in sys.argv[2].split(","):
            only[name](dev)
        return 0
    normal_path(dev)
    sync = {}     # the results later phases compare with
    kernels = sslp_path(dev, sync)
    torch.cuda.empty_cache()
    kernels.extend(ccopf_path(dev, sync))
    torch.cuda.empty_cache()
    kernels.append(scengen_path(dev))
    torch.cuda.empty_cache()
    farmer_path(dev)
    torch.cuda.empty_cache()
    uc_path(dev)
    torch.cuda.empty_cache()
    cli_path(sync)
    torch.cuda.empty_cache()
    profile_launches = profile_cli()
    torch.cuda.empty_cache()
    _, _, mip_launches = mip_path(dev)
    torch.cuda.empty_cache()
    _, slice9_launches = slice9_path(dev)
    torch.cuda.empty_cache()
    async_launches = async_path(dev, sync)
    torch.cuda.empty_cache()
    resilience_launches = resilience_path(dev, sync)
    # [profile_cli]'s windows ran in K2 and K1 (its capped CLI headline);
    # the MIP phases' node LPs ran in K1 (f32); the slice-9 paths in K1,
    # K2 (APH's bf16x3), the streamed box design (L-shaped masters, the
    # cross-scenario view) and a SOC design (the root-fixed ccopf EF);
    # the async wheel's in K1, K2 (its bf16x3 stale-prox hub step) and
    # the resident SOC kernel (ccopf); the checkpointed headline's in K2
    # and K1
    credit(kernels, profile_launches)
    credit(kernels, mip_launches)
    credit(kernels, slice9_launches)
    credit(kernels, async_launches)
    credit(kernels, resilience_launches)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
