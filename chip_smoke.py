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
* the split design — one problem's columns and rows over many blocks of
  a cooperative launch: timed against the streamed design at the
  one-problem shapes the port launches (the sampled EFs of 9 and 10
  sslp 15x45 scenarios, the L-shaped masters, [ci_seq]'s farmer EF, the
  root-fixed ccopf --soc EF) with its P swept, at S=2-66 of the sampled
  EF and at the cross-scenario view's batch, each with its bound and
  the share of it reached ([window_time_split]); held to its plain
  version at every one of those shapes in f32, bf16 and bf16x3 (SOC in
  f32), a done problem kept bit for bit and two launches bit-identical
  ([split_windows]);
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
  iteration with a short profile, each with 100 cold windows for PH's
  iter0 and FWPH's init (bench.py's 400 in --only uc_wheel_full);
* the CLI — generic_cylinders.main in this process, as
  `python -m mpisppy_tpu_torch` runs it: the README's sslp command
  without --presolve (cut to 1 hub iteration) and with it (also cut to 1)
  against the JAX package's bounds for each, the box kernel against its plain
  version on the presolved batch's per-scenario bounds, the sslp 15x45
  headline at 10,000 scenarios with all four fusable spokes in bf16x3
  for 6 hub iterations, its box windows in the design the shape rule
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
  as one problem on the split design from a mid-solve state that the
  window moves, APH's prox batch, all at 1,000 scenarios, and the
  cross-scenario PH and EF views with a round of cuts installed), then
  through the CLI at sslp 15x45: the L-shaped hub with the x̂-L-shaped
  spoke and its windows per Benders iteration at 1,000 scenarios, the
  APH hub in bf16x3 with half the scenarios dispatched at 10,000 and at
  100, a PH hub with the subgradient, Lagranger, PH-OB and reduced-costs
  outer bounds at 1,000, cross-scenario cuts on sslp 5x15 with the
  augmented batch's route, each against the JAX CLI, ccopf (3,3)
  --fused-wheel --xhatxbar with the root-fixed EF on the split SOC
  kernel (its window then held against its plain version), and the
  Schur-complement interior point in f64 against HiGHS (the CLI runs,
  [cli_ccopf_fused] and [sc] in a second process on the card, the card
  worker, beside the exact-MIP phases and the extensions' phases: each
  group spends its time in the host's launches);
* the async exchange wheel (algos/async_wheel.py) — bench.py's
  bench_wheel_overhead_async at sslp 15x45, S=10,000, bf16x3 (bare PH,
  the sync pair and the async pair at staleness 0/1/2 for 10 hub
  iterations: s/iter, overhead factors, the exchange halves, the host
  time blocked per iteration under a two-iteration profile, staleness 0
  equal to the sync pair row for row), the headline CLI flags with
  --async-staleness 1 --trace-jsonl for 6 hub iterations beside the
  sync headline's, the README's sslp command with --fused-wheel
  --async-staleness 1 against the JAX CLI's bounds and again with
  dropped and torn plane writes, and the ccopf (100,100) wheel at
  staleness 1 on the SOC kernel against the sync ccopf wheel's bounds;
* checkpoints and preemption — the headline wheel again with background
  checkpoints every second and a fault plan that preempts it at hub
  iteration 12 (the spinner's emergency save), every snapshot re-read
  and CRC-checked, then restored into a fresh wheel and resumed to hub
  iteration 20 against the uninterrupted [headline]'s rows (bounds to
  1e-3; the snapshot's
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
  7 hub iterations with --profile-dir, --profile-iters 2 and
  --trace-jsonl, then `python -m mpisppy_tpu_torch.telemetry analyze` on
  the trace (the capture found through its `profile` event) and `gate`
  on the run's device_profile.json: the capture's layout, no share of a
  peak above 1.0, K2 in the device report, the export's cost and the
  seconds per hub iteration before, inside and after the window; every
  profile phase reads its busy share through the package
  (telemetry/deviceprof.py, roofline.py), from the live profile and
  from its exported file;
* the remaining models — one window of each new dense shared-A shape
  (hydro on the (30, 30) tree, aircond on (3, 3, 2), gbd, sizes and
  usar at 10,000 scenarios, eval_candidates_exact's candidate batch on
  sslp 15x45) against its plain version in f32 and bf16x3 in every
  design the shape rule allows, with its route and resident layout
  ([models_windows]); bench.py's bench_hydro wheel (PH with SepRho, the
  EF outer bound, the fused Lagrangian, the root-fixed EF inner bound)
  on hydro (3, 3) on the card and on the CPU ([hydro_small]) and at
  (30, 30), 900 scenarios, in bf16x3 for 15 hub iterations (--full: to
  its 1% certificate) against the HiGHS optimum of the same extensive
  form, with its K2 launches and profiled busy share ([hydro_wheel], the
  slice's main path); aircond
  (3, 3, 2) with the EF spokes on the card and on the CPU, and its
  scengen program's VirtualBatch at 10,000 scenarios (realized, not
  drawn in-kernel) against the materialized batch, then for 10 hub
  iterations ([aircond], [aircond_program]); each model through the CLI
  (1 hub iteration, its route) and with --EF against HiGHS
  ([models_cli_*]; --full: the --EF runs at the wheel runs' sizes);
  eval_candidates_exact on the card against the CPU
  ([exact_candidates]); usar's certified MIP bracket against scipy's
  MILP ([usar_mip]); distr and stoch_distr through the admm wrappers
  against the merged LP ([admm_*]);
* the extensions, convergers and rho/W/x̄ utilities — the headline's CLI
  flags (sslp 15x45, S=10,000, bf16x3) with --grad-rho (updated every 2
  hub iterations, the scenario-independent denominator),
  --use-primal-dual-converger and --W-fname/--Xbar-fname
  /--rho-file-out for 6 hub iterations: K2 launched with the dynamic rho
  in force, rho moved at the first update, the files equal to the final
  state and the W file's slot means within the JAX check
  ([ext_cli_headline]); the same flags warm-started from those files
  for 2 (--rho-file-in, --init-W-fname, --init-Xbar-fname: installed as
  read, [ext_cli_warm]); find_grad_cost's fixed-nonant solve at 1,000
  scenarios through K1 against the plain window on the card, and
  XhatClosest on the 10,000-scenario wheel with its launches counted
  ([ext_grad_xhat]); --sensi-rho and --mult-rho on sslp 5x15, S=64, on
  the card and on the CPU ([ext_sensi], [ext_mult]); and
  --scenarios-per-bundle 10 at 1,000 scenarios, 100 proper bundles in
  ELL (no window kernel), pickled and unpickled to the same hub rows
  ([ext_bundles]);
* the confidence intervals and the rolling horizon — zhat4xhat's
  evaluate_sample_trees at the headline's certified incumbent root on
  three fresh samples of 10,000 sslp 15x45 scenarios through K1 f32
  resident, zhatbar +/- eps beside the headline's inner bound
  ([ci_zhat], the slice's full-width path); MMW at a fixed candidate
  over three batches of 9 (the dense sampled EF in the split design)
  against the JAX package's Glist and CI ([ci_mmw]), with that EF's
  windows in the kernel against the plain iteration ([ci_ef_route]);
  Bayraksan-Morton and
  Bayraksan-Pierre-Louis sequential sampling on farmer with an EF x̂
  generator, card against CPU ([ci_seq]); the multistage gap
  estimators and zhats on aircond (3, 3, 2) through its scengen program
  against the CPU and the JAX package ([ci_mstage]); the RollingDriver
  on ccopf --soc at the (100,100) tree, 10,000 scenarios, for 3 windows
  through the resident SOC kernel, each window that kept its warm start
  again cold, and the (3,3) horizon against the JAX driver's per-step
  bounds ([mpc_ccopf], [mpc_ccopf_small]); the CLI with --uc-mpc-step 1
  against the JAX CLI ([mpc_uc_cli]) — the two groups in two more card
  workers beside the MIP phases, their CPU comparisons here after the
  join;
* serving (serve/, mpc/stream.py) — an in-process WheelServer on a unix
  socket, its sessions in its worker threads on the card: the CLI
  headline (sslp 15x45, S=10,000, bf16x3, K2) served as one session and
  held to [cli_headline] ([serve_headline]); loadgen's mixed farmer /
  sslp / uc load from four clients of two tenants through the exchange
  ring, each session held to its solo run ([serve_mix]); two sessions'
  sslp node LPs (S=1,000 each) interned and coalesced into one K1
  dispatch of 2,000 lanes, each lane held to its solo solve
  ([serve_coalesce]); a uc MPC stream of 4 windows held to the
  RollingDriver, and a stream preempted entering window 2 resumed bit
  for bit ([serve_stream]) — in a card worker of its own, collected
  after the models' phases; then the served headline through a
  FleetRouter of two replicas on the card, its replica killed after hub
  iteration 2, migrated through the shared spool and held bit for bit
  to [serve_headline]'s rows ([fleet_migrate]);
* the scenario mesh (parallel/) — an NCCL process group of one rank in
  the CI worker: the headline batch sharded (shard_batch, pad=True) and
  its fused wheel's first 10 rows held bit for bit to [headline]'s, one
  hub iteration profiled for its NCCL calls ([mesh_nccl]); a sharded
  hydro (3,3) PH step's node averages against the unsharded step's
  ([mesh_hydro]); the sharded headline under run_elastic with a
  straggler past the harvest deadline at hub iteration 3: the emergency
  checkpoint, one re-shard onto 6 of 8 device slots (the scenario axis
  re-padded 10,000 -> 10,002) and the run to 1%, its bracket held to
  [headline]'s ([mesh_elastic]);

the CPU halves of the card-against-CPU phases ([wheel_small],
[wheel_soc_small], [scengen_small], [farmer_wheel], [hydro_small],
[aircond], [ext_sensi], [ext_mult], [ci_seq], [ci_mstage]) run in one
spawned worker process beside the card's phases (CpuHalves; in this
process under --only);

each wheel through WheelSpinner(hub_dict, spokes).spin(), with the launch
counts set to 0 just before it and read just after, to show that it went
through its kernel.  One line per phase; the script's seconds
([total]); then one JSON line describing each kernel, then the last
line {"ok": true, "device": {...}}.  Any
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
phase; `--only models` (or models_windows, hydro_small, hydro_wheel,
aircond, models_cli, exact_candidates, usar_mip, admm) the remaining
models' phases, `--full` with [hydro_wheel] to its 1% certificate (15
hub iterations in the default run) and the --EF runs of [models_cli] at
the wheel runs' sizes; `--only ext` (or ext_cli_headline: with
[ext_grad_xhat] and [ext_cli_warm], which share its wheel and files;
ext_sensi_mult, ext_bundles) the slice-14 phases; `--only ci` (or
ci_zhat, which runs [headline] first for its x̂; ci_mmw, ci_seq,
ci_mstage) the confidence-interval phases, `--only mpc` (or
mpc_ccopf, mpc_uc_cli) the rolling-horizon phases, `--only serve` (or
serve_headline, which runs [cli_headline] first; serve_mix,
serve_coalesce, serve_stream) the serving phases, `--only fleet`
([fleet_migrate], with [cli_headline] and [serve_headline] first) and
`--only mesh` (with [headline] first for its rows) this slice's, and
`--only window_time_split` the split design's.  Several cards are
needed for a mesh of more than one rank (NCCL takes one rank per card):
this script runs a world of one.
"""
import contextlib
import dataclasses
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
PROFILE_HUB_ITERS = 2                 # [headline_profile]'s capped run
                                      # (cut from 6, then 3)
PROFILE_CLI_ITERS = 7                 # [profile_cli]: the CLI headline's
PROFILE_CLI_WINDOW = 2                # cap and its --profile-iters
K2_KEY = "pdhg_window/bf16x3/resident"  # K2 in a device report
# kernel vs plain version, max |k - r| <= ATOL + RTOL * |r| after one
# window: f32 differs only in summation order (~1e-6 measured); bf16x3
# splits a value whose last bits differ, so its terms move by ~2^-16;
# bf16 keeps 8 bits an operand (tests/test_torch_cuda.py's tolerance)
TOLS = {"f32": (1e-4, 1e-4), "bf16x3": (1e-3, 1e-3), "bf16": (2e-2, 2e-2)}
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
# the CPU halves of the card-against-CPU phases ([wheel_small],
# [wheel_soc_small], [scengen_small], [farmer_wheel], [hydro_small],
# [aircond]) run in one spawned worker process beside the card's phases,
# with this many torch threads (the card's process keeps the others)
CPU_HALF_THREADS = 4
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
# end at rel_gap 0.416 (rho 1).  Without --presolve it runs 1 hub
# iteration (cut from 2 for the models phases; at 2 the JAX CLI gives
# -216.91704/-149.89996, at 3 -216.85544/-149.89996)
CLI_README = README_SSLP + ["--max-iterations", "1"]
# the JAX package's CLI on the CPU, the same command (python -m
# mpisppy_tpu --module-name mpisppy_tpu.models.sslp ... --max-iterations
# 1): (outer, inner); the port's must agree to 1e-3 relative
CLI_README_JAX_BOUNDS = (-216.97946166992188, -149.89996337890625)
# the README command as it is (with --presolve: FBBT) cut to 1 hub
# iteration (2 before the models phases, with the JAX CLI's
# -216.91693/-149.89996; 3 before the device profile's phase, -216.85530;
# 5 before the async wheel's, -216.73627; at 10 -216.44839): the JAX
# package's CLI on the CPU, the same command, gives (outer, inner); the
# port's must agree to 1e-4 relative
CLI_README_PRESOLVE = README_SSLP + ["--presolve", "--max-iterations", "1"]
CLI_README_PRESOLVE_JAX_BOUNDS = (-216.97947692871094, -149.89996337890625)
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
# the cold windows of PH's iter0 and FWPH's init in [uc_wheel],
# [uc_fwph_hub] and [uc_program] (cut from bench.py's 400 for the models
# phases: ~23 ms each at S=100, ~105 ms at S=10,000; [uc_wheel_full]
# keeps 400)
UC_ITER0_WINDOWS = 100
UC_PROGRAM_ITER0_WINDOWS = 20    # [uc_program]'s (no JAX hold there;
#                                  cut from 50)
# the JAX package on the CPU (tools/uc_jax_reference.py 100 1 1 100): the
# outer bound of [uc_wheel] (its inner bound has not landed by then, in
# either package) and the certified outer bound of [uc_fwph_hub], with
# UC_ITER0_WINDOWS cold windows; the port's must agree to 1e-3 relative.
# With 400 (tools/uc_jax_reference.py 100 1 1) both were 589529.1875,
# and [uc_wheel]'s the same at 3, 5, 10 and 25 hub iterations
UC_WHEEL_JAX_OUTER = 579162.875
UC_FWPH_HUB_JAX_OUTER = 577947.125
# the uc model through the CLI with flags the JAX CLI takes for the same
# run (python -m mpisppy_tpu --module-name mpisppy_tpu.models.uc ...)
CLI_UC = ["--module-name", "mpisppy_tpu_torch.models.uc",
          "--num-scens", str(UC_SCENS), "--fused-wheel", "--lagrangian",
          "--xhatxbar", "--slammax", "--fwph", "--rel-gap", "0.01",
          "--max-iterations", "1"]             # cut from 5, then 3
# [cli_headline] runs it for 6 hub iterations (cut from a 1%
# certificate, 77 iterations, which [headline] and [checkpoint_headline]
# reach through the same wheel), as [async_headline] and [profile_cli] do
CLI_HEADLINE_ITERS = 6                # (cut from 10)
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
                "--xhatxbar", "--rel-gap", "0.01", "--max-iterations", "2",
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
        # min on the CPU; the S=100 run cut from 3 iterations to 2, then to
        # 1 for the models phases (at 2 the JAX CLI gives -317.75183/
        # -284.23007); the S=10,000 run keeps 2 (half the scenarios are
        # dispatched from the second on)
        "aph_hub": [
            ("aph_hub", sslp_cli(APH_SCENS, *APH_FLAGS,
                                 *d(APH_BF16X3, APH_BF16X3[:2]),
                                 "--max-iterations", d("2", "30")), None),
            ("aph_hub_100", sslp_cli(100, *APH_FLAGS, *d(APH_BF16X3, []),
                                     "--max-iterations", d("1", "30")),
             d((-318.3777770996094, -284.2300720214844),
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
# the headline CLI flags at staleness 1, traced, capped at 6 hub
# iterations (cut from a 1% certificate, 80 iterations, then 10; --full:
# to 1%)
CLI_ASYNC_HEADLINE = CLI_HEADLINE + ["--async-staleness", "1"]
ASYNC_HEADLINE_ITERS = {False: 6, True: HEADLINE_MAX_ITERS}  # (was 10)
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
# files, so each can be re-read), preempted at hub iteration
# CKPT_PREEMPT_AT by a fault plan and resumed to hub iteration
# CKPT_RESUME_TO (cut from 40 and a resume to the 1% certificate, 77);
# the README's sslp command through the CLI, run to PREEMPT_CLI_CAP PH
# iterations at most and sent SIGTERM once its trace shows hub iteration
# PREEMPT_CLI_AT (cut from 3), then resumed, like the uninterrupted run
# it is held to, for two more PH iterations
CKPT_EVERY_S = 1.0
CKPT_KEEP = 64
CKPT_PREEMPT_AT = 12                  # a hub iteration (Iter0's sync is 1)
CKPT_RESUME_TO = 20                   # a PH iteration: hub iteration 21
PREEMPT_CLI_AT = 2                    # at 1 the snapshot precedes the
#                                       classic x̂ spoke's first bound
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
                                    for f in ("c", "q", "l", "u", "bl", "bu")
                                    if getattr(qp, f).ndim == 2})
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
    ones mode/resident_cones/scenarios-per-tile, split ones
    mode/split/kind/where A's slab sits (smem or L2)."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"pdhg_window_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
                      ln)
        r = re.search(r"pdhg_window_residentILi(\d+)ELb(\d)E", ln)
        c = re.search(r"pdhg_window_conesILi(\d+)ELi(\d+)E", ln)
        sp = re.search(r"pdhg_window_splitILi(\d+)ELb(\d)ELb(\d)E", ln)
        if "Compiling entry function" in ln and (m or r or c or sp):
            if sp:
                name = (f"{MODE_NAMES[sp[1]]}/split/"
                        f"{'cones' if sp[2] == '1' else 'box'}/"
                        f"{'smem' if sp[3] == '1' else 'L2'}")
            elif m:
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
SPLIT_SOURCE = "mpisppy_tpu_torch/csrc/pdhg_window_split.cu"


def kernel_entry(name, source, replaces, launches, err, timing):
    ms, plain, bound, by = timing
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def parity(args, mode, label, S, synth=None, design=None, floor=False,
           **extra):
    """Kernel against its plain version on the same inputs; done lanes
    must come back bit-unchanged.  `design` names the kernel's design
    (None: the shape rule's).  The kernel passes within TOLS of the plain
    version element by element, or, with `floor`, where field by field
    (x, y, x_sum, y_sum) it lies no farther from the plain version run in
    f64 (f64_reference) than twice the plain f32 version does, plus
    TOLS' atol: on a batch whose f32 rounding floor lies above TOLS
    (sizes' columns of 10^4-10^5, gbd's window sums) both f32 versions
    sit that far from exact arithmetic, in other directions.  Returns
    (max_abs_err vs plain, kernel out)."""
    from mpisppy_tpu_torch.ops import pdhg_window
    k = pdhg_window.run_window(*args, precision=mode, synth=synth,
                               design=design)
    r = pdhg_window.run_window_reference(*args, precision=mode, synth=synth)
    torch.cuda.synchronize()
    err, ok = max_err(k, r, mode)
    done = args[7]
    frozen = torch.equal(k[0][done], args[1][done]) \
        and torch.equal(k[1][done], args[2][done])
    within = {}
    if floor and not ok:
        e = f64_reference(args)
        kd = [float((a.double() - b).abs().max()) for a, b in zip(k, e)]
        rd = [float((a.double() - b).abs().max()) for a, b in zip(r, e)]
        ok = all(a <= 2.0 * b + TOLS[mode][0] for a, b in zip(kd, rd)) \
            and all(bool(torch.isfinite(t).all()) for t in k)
        within = dict(kernel_vs_f64=json.dumps(kd).replace(" ", ""),
                      plain_vs_f64=json.dumps(rd).replace(" ", ""),
                      within_f32_floor=ok)
    phase(label, S=S, mode=mode, n_iters=args[8],
          design=design or "rule", max_abs_err=err,
          tol=f"{TOLS[mode][0]}+{TOLS[mode][1]}*|plain|", ok=ok,
          done_lanes_unchanged=frozen, **within, **extra)
    if not (ok and frozen):
        raise AssertionError(f"{label}: window kernel disagrees ({mode})")
    return err, k


def f64_reference(args):
    """The plain version run in f64 on the same inputs, with f64 products
    in every mode: the window's arithmetic up to f64 rounding."""
    import dataclasses

    from mpisppy_tpu_torch.ops import pdhg_window
    qp = args[0]
    q64 = dataclasses.replace(qp, **{f: getattr(qp, f).double() for f in
                                     ("A", "c", "q", "l", "u", "bl", "bu")})
    rest = tuple(t.double() if t.is_floating_point() else t
                 for t in args[1:8])
    return pdhg_window.run_window_reference(q64, *rest, args[8])


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


def small_wheel(label, model, gpu_batch, opts, **extra):
    """The same wheel on the card and on the CPU (its CPU half, `label`,
    from CPU_HALVES): both certify 1% and their bounds agree to 1e-3
    relative.  Returns the card's spinner."""
    g, g_s = wheel(gpu_batch, opts)
    c = CPU_HALVES.result(label)
    g_gap = g.spcomm.compute_gaps()[1]
    rel = [abs(a - b) / abs(b) for a, b in
           ((g.BestOuterBound, c["outer"]), (g.BestInnerBound, c["inner"]))]
    phase(label, S=gpu_batch.num_scenarios, model=model,
          gpu_iters=g.spcomm._iter, cpu_iters=c["iters"],
          outer=g.BestOuterBound, inner=g.BestInnerBound, rel_gap=g_gap,
          cpu_outer=c["outer"], cpu_inner=c["inner"],
          cpu_rel_gap=c["rel_gap"], max_rel_diff=max(rel),
          gpu_s=round(g_s, 2), cpu_s=round(c["s"], 2), **extra)
    if not (g_gap <= 0.01 and c["rel_gap"] <= 0.01 and max(rel) <= 1e-3):
        raise AssertionError(f"{label}: no 1% certificate on the card or "
                             "the CPU, or their bounds disagree")
    return g


def small_sslp_options():
    """The sslp 5x15 S=64 wheels' options ([wheel_small],
    [scengen_small])."""
    return sslp_options(None, 200, 1e-7, 10)


def summary(ws, secs):
    """What a card phase compares of a CPU half: bounds, hub iterations,
    relative gap and wall seconds."""
    return {"outer": ws.BestOuterBound, "inner": ws.BestInnerBound,
            "iters": ws.spcomm._iter, "rel_gap": ws.spcomm.compute_gaps()[1],
            "s": secs}


def cpu_half(name):
    """The CPU half of phase `name`, built as the phase builds its card
    half (summary)."""
    torch.set_num_threads(CPU_HALF_THREADS)
    if name == "wheel_small":
        return summary(*wheel(sslp_batch(64, 5, 15, "cpu"),
                              small_sslp_options()))
    if name == "wheel_soc_small":
        return summary(*wheel(ccopf_batch(CCOPF_SMALL_BFS, "cpu"),
                              ccopf_options()))
    if name == "scengen_small":
        from mpisppy_tpu_torch import scengen
        return summary(*wheel(scengen.virtual_batch(
            sslp_program(SCENGEN_SMALL_SCENS, 5, 15), device="cpu"),
            small_sslp_options()))
    from mpisppy_tpu_torch.core import batch as batch_mod
    if name == "farmer_wheel":
        from mpisppy_tpu_torch.models import farmer
        specs = [farmer.scenario_creator(nm, num_scens=FARMER_SMALL_SCENS)
                 for nm in farmer.scenario_names_creator(FARMER_SMALL_SCENS)]
        ws, secs, _ = farmer_wheel(batch_mod.from_specs(specs, device="cpu"),
                                   5e-3)
        return summary(ws, secs)
    if name in EXT_SMALL_RHO:
        return ext_small_cli(name, "cpu")[0]
    if name.startswith("ci_seq_"):
        return ci_seq_run(name[len("ci_seq_"):], "cpu")
    if name == "ci_mstage":
        return ci_mstage_run("cpu")
    if name == "mpc_uc_cli":
        return mpc_uc_cpu()
    bfs, dicts = {"hydro_small": (HYDRO_SMALL_BFS, lambda b, sp, t:
                                  hydro_wheel_dicts(b, sp, t,
                                                    HYDRO_MAX_ITERS)),
                  "aircond": (AIRCOND_BFS, aircond_wheel_dicts)}[name]
    specs, tree = model_specs(name.split("_")[0], bfs=bfs)
    b = batch_mod.from_specs(specs, tree=tree, device="cpu")
    return summary(*spin(*dicts(b, specs, tree), "cpu"))


class CpuHalves:
    """The CPU halves as futures of one spawned worker process (start),
    or computed in this process when none was started (an --only run).
    close() stops the worker."""

    NAMES = ("wheel_small", "wheel_soc_small", "scengen_small",
             "farmer_wheel", "hydro_small", "aircond", "ext_sensi",
             "ext_mult", "ci_seq_BM", "ci_seq_BPL", "ci_mstage",
             "mpc_uc_cli")

    def __init__(self):
        self.pool = None
        self.futures = {}

    def start(self):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        self.futures = {n: self.pool.submit(cpu_half, n) for n in self.NAMES}

    def result(self, name):
        fut = self.futures.pop(name, None)
        return cpu_half(name) if fut is None else fut.result()

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


CPU_HALVES = CpuHalves()


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


_KERNEL_NAME = re.compile(
    r"pdhg_window_(kernel|resident|cones|split)<(\d+)")


def window_kernel_key(name):
    """mode/design of a window kernel from its demangled name
    (pdhg_window_kernel<MODE, ...> is the streamed body,
    pdhg_window_resident<MODE, ...> and pdhg_window_cones<MODE, ...> the
    resident ones, pdhg_window_split<MODE, ...> the split one), else
    None."""
    m = _KERNEL_NAME.search(name)
    if m is None:
        return None
    design = {"kernel": "streamed", "split": "split"}.get(m[1], "resident")
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
                small_sslp_options())

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
    import numpy as np
    root = np.asarray(ws.opt.batch.tree.slot_stage) == 1
    sync["headline"] = {"batch": batch, "rows": trace_rows(ws),
                        "bounds": (ws.BestOuterBound, ws.BestInnerBound),
                        "iterations": ws.spcomm._iter,
                        "xhat": np.array(ws.spcomm.best_nonants()[0])[root]}
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
                ccopf_batch(CCOPF_SMALL_BFS, dev), ccopf_options())

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


# the split design ([window_time_split], [split_windows]): the small-S
# points of the sampled EF and the cross-scenario view's batch, and the
# (blocks an SM, least columns a block) pairs its f32 sweep of P times
SPLIT_SMALL_S = (2, 4, 8, 16, 33, 66)
CROSS_VIEW = (820, 85, 100)
SPLIT_SWEEP = ((1, 1), (2, 1), (1, 8), (2, 8), (1, 32))


def sslp_ef_problem(num_scens, dev):
    """The dense sampled EF of num_scens sslp 15x45 scenarios as one
    problem (gap_estimators' route): 660 x 6,345 at 9, 735 x 7,050 at
    10."""
    from mpisppy_tpu_torch.algos.ef import build_ef
    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.ops import boxqp
    inst = sslp.synthetic_instance(SSLP_SERVERS, SSLP_CLIENTS)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=num_scens,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(num_scens)]
    return boxqp.one_problem(build_ef(specs, device=dev).qp)


def ccopf_ef_problem(dev):
    """The ccopf --soc (3,3) EF as one problem: 663 x 729 with SOC rows,
    the shape of EFXhatInnerBound's root-fixed EF."""
    from mpisppy_tpu_torch.algos.ef import build_ef
    from mpisppy_tpu_torch.models import ccopf
    from mpisppy_tpu_torch.ops import boxqp
    specs = [ccopf.scenario_creator(nm, branching_factors=CCOPF_SMALL_BFS,
                                    soc=True)
             for nm in ccopf.scenario_names_creator(9)]
    qp = boxqp.one_problem(build_ef(
        specs, tree=ccopf.make_tree(CCOPF_SMALL_BFS), device=dev).qp)
    if qp.cones is None or not isinstance(qp.A, torch.Tensor):
        raise AssertionError("ccopf EF: no cone spec, or not dense")
    return qp


def random_lp(m, n, S, dev, seed=8):
    """A random dense box LP of one shape (an L-shaped master's cut
    buffer, [ci_seq]'s farmer EF, the cross-scenario view) with S
    problems: rows around a feasible point, one row one-sided."""
    import numpy as np

    from mpisppy_tpu_torch.ops import boxqp
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    b = rng.uniform(0.2, 0.8, size=(S, n)) @ A.T
    bl = b - rng.uniform(0.5, 1.5, size=(S, m))
    bu = b + rng.uniform(0.5, 1.5, size=(S, m))
    bl[:, 0] = -np.inf
    return boxqp.make_boxqp(rng.normal(size=(S, n)), A, bl, bu,
                            np.zeros((S, n)), np.ones((S, n)), device=dev)


def split_shapes(dev):
    """[window_time_split]'s shapes: label -> window inputs (a random
    mid-solve state; lane 1 done at each S > 1 of the sampled EF)."""
    ef9 = sslp_ef_problem(9, dev)
    one = random_state_args(ef9)
    shapes = {"ef_660x6345": one,
              "ef_735x7050": random_state_args(sslp_ef_problem(10, dev)),
              "lshaped_master_256x16": random_state_args(
                  random_lp(256, 16, 1, dev)),
              "lshaped_master_256x1015": random_state_args(
                  random_lp(256, 1015, 1, dev)),
              "ci_seq_ef_197x240": random_state_args(
                  random_lp(197, 240, 1, dev)),
              "ccopf_ef_663x729": random_state_args(ccopf_ef_problem(dev))}
    for S in SPLIT_SMALL_S:
        a = tiled(one, S)
        a[7][1] = True
        shapes[f"ef_660x6345_S{S}"] = a
    m, n, S = CROSS_VIEW
    shapes[f"cross_scen_view_{m}x{n}_S{S}"] = random_state_args(
        random_lp(m, n, S, dev))
    return shapes


@contextlib.contextmanager
def split_knobs(per_sm, min_cols):
    """The split design's P rule at (blocks an SM, least columns a
    block), for the sweep of [window_time_split]."""
    from mpisppy_tpu_torch.ops import pdhg_window
    old = pdhg_window.SPLIT_BLOCKS_PER_SM, pdhg_window.SPLIT_MIN_COLS
    pdhg_window.SPLIT_BLOCKS_PER_SM, pdhg_window.SPLIT_MIN_COLS = \
        per_sm, min_cols
    try:
        yield
    finally:
        pdhg_window.SPLIT_BLOCKS_PER_SM, pdhg_window.SPLIT_MIN_COLS = old


def split_time(label, args, mode):
    """ms of one window split against streamed (in turns: split,
    streamed, streamed, split; streamed where it takes the shape), the
    plain version's, the bound and the share of it the split kernel
    reaches.  Returns (split ms, plain ms, bound ms, bound_by)."""
    from mpisppy_tpu_torch.ops import pdhg_window
    qp, S = args[0], args[1].shape[0]
    cone_ints = pdhg_window.cone_ints_of(qp, qp.device)
    streams = pdhg_window.streamed_fits(qp.m, qp.n, pdhg_window.card_limits(
        torch.cuda.current_device())[0], cone_ints)
    order = ["split", "streamed", "streamed", "split"] if streams \
        else ["split", "split"]
    ms = {"split": [], "streamed": []}
    for d in order:
        ms[d].append(time_ms(lambda: pdhg_window.run_window(
            *args, precision=mode, design=d), reps=5))
    plain = time_ms(lambda: pdhg_window.run_window_reference(
        *args, precision=mode), reps=2)
    bound, by = window_bound_ms(args, mode)
    split = sum(ms["split"]) / len(ms["split"])
    stream = sum(ms["streamed"]) / len(ms["streamed"]) if streams else None
    phase("window_time_split", shape=label, S=S, m=qp.m, n=qp.n, mode=mode,
          n_iters=args[8], plan=plan_line(qp, S, mode),
          split_ms="/".join(f"{v:.4f}" for v in ms["split"]),
          streamed_ms="/".join(f"{v:.4f}" for v in ms["streamed"])
          if streams else "none",
          split_over_streamed=round(split / stream, 4) if streams
          else "none", plain_ms=round(plain, 4), bound_ms=round(bound, 5),
          bound_by=by, share_of_bound=round(bound / split, 5))
    return split, plain, bound, by


def split_sweep(label, args):
    """f32 ms of one split window at each (blocks an SM, least columns a
    block) of SPLIT_SWEEP, the P that gives and whether A's slab sat in
    shared memory; a grid the card cannot hold prints its error."""
    from mpisppy_tpu_torch.ops import pdhg_window
    qp, S = args[0], args[1].shape[0]
    out = []
    for per_sm, min_cols in SPLIT_SWEEP:
        with split_knobs(per_sm, min_cols):
            plan = pdhg_window.plan_window(
                "f32", qp.m, qp.n, S, *pdhg_window.card_limits(
                    torch.cuda.current_device()),
                cone_ints=pdhg_window.cone_ints_of(qp, qp.device),
                design="split")
            try:
                ms = f"{time_ms(lambda: pdhg_window.run_window(*args, design='split'), reps=5):.4f}"
            except RuntimeError as e:
                ms = f"'{str(e)[:60]}'"
        out.append(f"{per_sm}x{min_cols}:P{plan.tile}"
                   f"{'s' if plan.a_smem else 'l'}={ms}")
    phase("window_time_split", shape=label, S=S, sweep_f32=",".join(out))


def split_path(dev):
    """[window_time_split] and [split_windows]: the split design timed
    against the streamed one at every shape of split_shapes (f32; bf16x3
    too at the sampled EF), with its P swept at the one-problem shapes;
    held to its plain version at every shape in f32, bf16 and bf16x3 (SOC
    in f32), done lanes (S=4 with lane 1 done, and S=1 done) and two
    launches bit-identical.  Returns the kernels line's entries of the
    box and SOC split instantiations (launches 0: the main path's runs
    credit them)."""
    from mpisppy_tpu_torch.ops import pdhg_window
    t0 = time.perf_counter()
    shapes = split_shapes(dev)
    timing, errs = {}, {}
    for label, args in shapes.items():
        soc = args[0].cones is not None
        modes = ("f32",) if soc else ("f32", "bf16", "bf16x3")
        for mode in modes:
            e = held_window(label, args[0], args, soc=soc, modes=(mode,),
                            group="split_windows", design="split",
                            floor=mode == "bf16")
            errs[label, mode] = e[mode]
        timing[label, "f32"] = split_time(label, args, "f32")
        if label == "ef_660x6345":
            timing[label, "bf16x3"] = split_time(label, args, "bf16x3")
        if args[1].shape[0] in (1, 4, 16):
            split_sweep(label, args)
    # S=1 done: the iterates stay bit for bit, the sums accumulate
    one = shapes["ef_660x6345"]
    frozen = one[:7] + (torch.ones_like(one[7]),) + one[8:]
    k = pdhg_window.run_window(*frozen, design="split")
    torch.cuda.synchronize()
    kept = torch.equal(k[0], one[1]) and torch.equal(k[1], one[2])
    sums = float((k[2] - (one[3] + N_ITERS * one[1])).abs().max())
    # two launches bit-identical, box and SOC
    same = {}
    for label in ("ef_660x6345", "ccopf_ef_663x729"):
        a = pdhg_window.run_window(*shapes[label], design="split")
        b = pdhg_window.run_window(*shapes[label], design="split")
        same[label] = all(torch.equal(u, v) for u, v in zip(a, b))
    phase("split_windows", s1_done_unchanged=kept, s1_done_sum_err=sums,
          deterministic=json.dumps(same).replace(" ", ""),
          seconds=round(time.perf_counter() - t0, 2))
    if not (kept and sums <= 1e-3 * max(1.0, float(one[1].abs().max()))
            and all(same.values())):
        raise AssertionError("split_windows: a done problem moved, or two "
                             "launches differ")
    del shapes
    torch.cuda.empty_cache()
    return [kernel_entry("pdhg_window_split", SPLIT_SOURCE,
                         "mpisppy_tpu/ops/pdhg_pallas.py:491", 0,
                         errs["ef_660x6345", "f32"],
                         timing["ef_660x6345", "f32"]),
            kernel_entry("pdhg_window_soc_split", SPLIT_SOURCE,
                         "mpisppy_tpu/ops/pdhg_pallas.py:192", 0,
                         errs["ccopf_ef_663x729", "f32"],
                         timing["ccopf_ef_663x729", "f32"])]


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
    c = CPU_HALVES.result("farmer_wheel")
    rel = max(abs(a - b) / abs(b) for a, b in (
        (g.BestOuterBound, c["outer"]), (g.BestInnerBound, c["inner"])))
    inner_vs_ef = abs(g.BestInnerBound - FARMER_EF_OBJ) / abs(FARMER_EF_OBJ)
    phase("farmer_wheel", S=FARMER_SMALL_SCENS, model="farmer",
          hub_iters=g.spcomm._iter, cpu_hub_iters=c["iters"],
          outer=g.BestOuterBound, inner=g.BestInnerBound,
          rel_gap=g.spcomm.compute_gaps()[1], cpu_outer=c["outer"],
          cpu_inner=c["inner"], max_rel_diff=rel,
          inner_vs_ef=inner_vs_ef, wall_s=round(g_s, 3),
          cpu_wall_s=round(c["s"], 3), plain_windows=g_plain,
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
    --presolve (cut to 1 hub iteration) and with it (also cut to 1), each
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


def uc_wheel(batch, max_iterations, iter0_windows=400):
    """bench.py's bench_uc_fwph wheel: PH hub (rho 1 with
    SepRho(multiplier=2), 10 subproblem windows, tol 1e-6, restart period
    40, bf16x3 iteration precision: ignored by the ELL products), the
    FWPH spoke (rho 200, its PDHG at tol 1e-6 and 4,000 iterations), the
    fused Lagrangian, x̂-x̄ and slam planes (slam_windows 2) and
    spoke_sync_period 5.  PH's iter0 and FWPH's init solves take at most
    `iter0_windows` cold windows (both packages' default: 400).  Returns
    the spinner, its wall seconds and its plain-iteration windows."""
    import functools

    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.extensions.rho_setters import SepRho
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.algos.fwph import FWPHOptions
    opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=10, iter0_windows=iter0_windows,
        pdhg=pdhg.PDHGOptions(tol=1e-6, restart_period=N_ITERS,
                              iter_precision="bf16x3"))
    spoke_pdhg = pdhg.PDHGOptions(tol=1e-6, max_iters=4_000)
    spokes = [{"spoke_class": spoke.FWPHOuterBound,
               "opt_kwargs": {"options": {
                   "rho": 200.0, "pdhg_opts": spoke_pdhg,
                   "fw_opts": FWPHOptions(iter0_windows=iter0_windows)}}}]
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
                   jax_outer=None, iter0_windows=400):
    """uc_wheel with the launch counts set to 0 just before and read just
    after (an ELL batch launches no window kernel); its outer bound must
    be finite, below any inner bound and, given `jax_outer`, within 1e-3
    of the JAX package's."""
    reset_launches()
    ws, secs, plain = uc_wheel(batch, max_iterations, iter0_windows)
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
          # with the cold windows of PH's iter0 and FWPH's init
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
        default_rho=200.0, oracle_windows=10, iter0_windows=UC_ITER0_WINDOWS,
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
                           model="uc_10g24h_scengen",
                           iter0_windows=UC_PROGRAM_ITER0_WINDOWS)
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
                   jax_outer=UC_WHEEL_JAX_OUTER,
                   iter0_windows=UC_ITER0_WINDOWS)
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
    opts = small_sslp_options()
    g = small_wheel("scengen_small", "sslp_5_15_scengen",
                    scengen.virtual_batch(prog, device=dev), opts)
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


def node_boxes(batch, shift=0):
    """B&B node boxes at the batch's shapes: the integer root box with
    lane s's first ((s + shift) mod 97) integer columns fixed (l == u at
    (s + shift) mod 2).  Returns (integer columns, lo, hi)."""
    from mpisppy_tpu_torch.ops import bnb
    qp, dev = batch.qp, batch.device
    ic = torch.nonzero(batch.integer_full)[:, 0]
    lo, hi = (torch.as_tensor(v, device=dev) for v in
              bnb._root_bounds(qp, batch.d_col, ic.cpu().numpy()))
    S = qp.c.shape[0]
    k = (torch.arange(S, device=dev) + shift) % 97
    fixed = torch.arange(ic.numel(), device=dev)[None, :] < k[:, None]
    val = ((torch.arange(S, device=dev) + shift) % 2).to(lo.dtype)[:, None]
    lo = torch.where(fixed, val.expand_as(lo), lo)
    hi = torch.where(fixed, val.expand_as(hi), hi)
    return ic, lo, hi


def bnb_node_args(batch, seed=0):
    """B&B node operands at the batch's shapes: node_boxes, lane 3's
    first integer column emptied (l > u), a window input two windows
    into the solve (warm state) with every 7th lane done.  Returns
    (window args, node qp, the emptied column)."""
    import dataclasses

    from mpisppy_tpu_torch.ops import bnb
    ic, lo, hi = node_boxes(batch)
    lo[3, 0], hi[3, 0] = 1.0, 0.0
    node = bnb._node_qp(batch.qp, batch.d_col, ic, lo, hi)
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



def plan_line(qp, S, mode="f32", design=None):
    """The plan plan_window gives a window of `qp` at S scenarios (the
    SOC layout's ints with cones) in `design` (None: the rule's), as
    design/tile/blocks (split: /P with A's slab in shared memory or
    /L2)."""
    from mpisppy_tpu_torch.ops import pdhg_window
    plan = pdhg_window.plan_window(
        mode, qp.m, qp.n, S, *pdhg_window.card_limits(
            torch.cuda.current_device()),
        cone_ints=pdhg_window.cone_ints_of(qp, qp.device), design=design)
    if plan.design == "split":
        return (f"split/P{plan.tile}/blocks{plan.blocks}/"
                f"{'smem' if plan.a_smem else 'L2'}")
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


def held_window(label, qp, args, soc=False, modes=("f32", "bf16x3"),
                group="slice9_windows", floor=False, design=None, **extra):
    """parity() of one window of a new batch shape in each of `modes` at
    TOLS (or, with `floor`, parity's f32-floor rule), in `design` or
    the one plan_window gives (printed as its route), on `group`'s lines; the
    window must move x and y (a state at a fixed point checks nothing).
    SOC windows also keep their duals in the polar cone.  Returns
    {mode: max_abs_err}."""
    from mpisppy_tpu_torch.ops import cones
    S = args[1].shape[0]
    errs = {}
    for mode in modes:
        errs[mode], k = parity(args, mode, group, S, floor=floor,
                               design=design, shape=label, m=qp.m, n=qp.n,
                               route=plan_line(qp, S, mode, design),
                               **extra)
        moved_x = float((k[0] - args[1]).abs().max())
        moved_y = float((k[1] - args[2]).abs().max())
        dcr = float(cones.dual_cone_residual_rows(qp.cones, k[1]).max()) \
            if soc else 0.0
        phase(group, shape=label, mode=mode, moved_x=moved_x,
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
            and by_design.get("pdhg_window/f32/split", 0) > 0):
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
    route = plan_line(qp, ws.opt.batch.num_scenarios)
    phase(label, cuts_installed=ext.cuts_installed,
          rounds=ext.meta.rounds_used, m_orig=ext.meta.m_orig, m=qp.m,
          n=qp.n, route=route, ob_char=ws.spcomm.latest_ob_char)
    design = route.split("/")[0]
    if not (ext.cuts_installed > 0 and qp.m == ext.meta.aug_ph.qp.m
            and by_design.get(f"pdhg_window/f32/{design}", 0) > 0):
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


def slice9_cli_runs(full=False):
    """The decomposition hubs and bound spokes through the CLI
    (slice9_table(full)), [cli_ccopf_fused] and [sc].  Returns the
    launches by design."""
    t0 = time.perf_counter()
    total = {}
    for name, check in CHECKS.items():
        merge_launches(total, slice9_runs(slice9_table(full), name,
                                          check))
    merge_launches(total, ccopf_fused_phase())
    sc_phase(torch.device("cuda"))
    phase("slice9_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return total


def captured(fn_name, *args):
    """chip_smoke.<fn_name>(*args) with its phase lines captured:
    (the lines, its result).  The card worker's entry."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = globals()[fn_name](*args)
    return out.getvalue(), result


class CardWorker:
    """One spawned process on the same card running a group of
    host-bound phases (their launches counted in that process) beside
    this process's: every phase of the script spends most of its time
    in the host's launches, so two host loops share the card.  Its phase
    lines are printed here when result() collects them; close() stops
    the process."""

    def __init__(self):
        self.pool = None
        self.future = None

    def start(self, fn_name, *args):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        self.future = self.pool.submit(captured, fn_name, *args)

    def result(self):
        lines, result = self.future.result()
        print(lines, end="", flush=True)
        self.close()
        return result

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


CARD_WORKER = CardWorker()
CI_WORKER = CardWorker()
MPC_WORKER = CardWorker()
SERVE_WORKER = CardWorker()


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
    if not ((not full or (result["rel_gap"] is not None
                          and result["rel_gap"] <= 0.01))
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
    freshly built wheel restores the newest snapshot and resumes to hub
    iteration CKPT_RESUME_TO.  Prints the snapshot's bytes and
    leaves, the background saves (each re-read and CRC-checked), the
    emergency save's and the restore's seconds, seconds per hub
    iteration before the preemption against [headline]'s over the same
    rows (the background writes' cost), and the last resumed row's
    bounds against [headline]'s row of that iteration (held at 1e-3
    relative), and whether the resumed rows equal [headline]'s (the
    snapshot's extras carry the fused wheel's host step cycle) or the
    first that differs.  Returns the launches by design of both runs."""
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
        ws2 = WheelSpinner(*wheel_dicts(
            batch, dataclasses.replace(opts, max_iterations=CKPT_RESUME_TO),
            hub_extra={"checkpoint_path": path,
                       "checkpoint_every_s": 1e9})).build()
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
    # the last resumed row against [headline]'s row of that iteration
    want = by_iter.get(after[-1]["iter"], {})

    def rel_to(a, b):
        if b is None or not math.isfinite(b):
            return 0.0 if a == b else math.inf
        return abs(a - b) / abs(b)
    rel = max(rel_to(after[-1]["outer"], want.get("outer")),
              rel_to(after[-1]["inner"], want.get("inner")))
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
          resumed_last_iter=after[-1]["iter"],
          headline_iterations=ref["iterations"], resume_s=round(resume_s, 2),
          outer=outer, inner=inner, rel_gap=rel_gap,
          headline_row_outer=want.get("outer"),
          headline_row_inner=want.get("inner"),
          max_rel_diff_vs_headline_row=rel, tol=1e-3)
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
            and after[-1]["iter"] == CKPT_RESUME_TO + 1 and rel <= 1e-3):
        raise AssertionError("checkpoint_headline: wrong snapshot, no "
                             "background save, the resume did not reach "
                             "its cap, or bounds off [headline]'s row")
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


# slice 13: the remaining models.  hydro at bench.py's bench_hydro width
# (the (30, 30) tree, 900 scenarios) through bench_hydro's wheel: PH hub
# with SepRho(multiplier=2), 8 subproblem windows at PDHG tol 1e-6 in
# bf16x3, the EF outer bound and the root-fixed EF inner bound (20
# windows each), the fused Lagrangian, no x̄ plane, spoke_sync_period 5,
# at most 600 hub iterations
HYDRO_BFS = (30, 30)
HYDRO_SMALL_BFS = (3, 3)
HYDRO_MAX_ITERS = 600                 # bench_hydro: 2 * MAX_WHEEL_ITERS
# [hydro_wheel]'s cap in the default run (--full: to its 1% certificate,
# 90 hub iterations and 34-42 s on an H100): both bounds are published
# from hub iteration 5 on, and at 30 the inner one is still the loose
# root-fixed EF value of an early candidate
HYDRO_WHEEL_ITERS = {False: 15, True: HYDRO_MAX_ITERS}  # (was 30)
# an outer bound at most, an inner bound at least, the HiGHS EF optimum
# within this share of |EF*| (tests/test_models_zoo.py's
# test_aircond_honest_inner_multistage_wheel)
EF_SLACK = 5e-3
AIRCOND_BFS = (3, 3, 2)               # the model's default tree
AIRCOND_PROGRAM_BFS = (25, 20, 20)    # the program's VirtualBatch, 10,000
AIRCOND_PROGRAM_ITERS = 10
# the VirtualBatch's first hub iteration against the materialized
# batch's: the realized data are equal bit for bit, but a tree deeper
# than two stages averages its nodes with index_add_, whose CUDA sums
# run in atomic order, so two runs on one batch differ in the last bits
# of conv (ROADMAP C1)
AIRCOND_FIRST_ITER_RTOL = 1e-5
# [models_windows]: the batch size of the two-stage dense shapes (their
# specs built at a tenth of it and the window inputs tiled, as `tiled`
# makes the S=100,000 sweep: building 10,000 specs costs ~13 s), and
# eval_candidates_exact's K candidates over S scenarios of sslp 15x45
MODEL_WINDOW_SCENS = 10_000
MODEL_WINDOW_TILES = 10               # built at 1,000, tiled to 10,000
EXACT_K, EXACT_S = 4, 250
EXACT_RUN_K, EXACT_RUN_S = 2, 10      # the evaluation run on the card
# [models_cli]: each model at its CLI size (the module's default where it
# has one), the fused wheel with the Lagrangian and x̂-x̄ spokes capped
# at 1 hub iteration; box: the batch takes the window kernel (a dense
# shared A), else the plain iteration
MODELS_CLI = [
    ("gbd", ["--num-scens", "100"], True),
    ("sizes", ["--num-scens", "10"], True),
    ("apl1p", ["--num-scens", "100"], False),
    ("netdes", [], False),
    ("battery", ["--num-scens", "10", "--battery-use-lp"], False),
    ("usar", ["--num-scens", "10"], True),
    ("aircond", [], True),
    ("hydro", ["--branching-factors", "30", "30"], True),
]
MODELS_CLI_WHEEL = ["--fused-wheel", "--lagrangian", "--xhatxbar",
                    "--max-iterations", "1"]     # (cut from 2)
# then --EF against HiGHS on the same extensive form (its LP relaxation):
# an EF the CLI reports converged must lie within CLI_EF_RTOL of HiGHS;
# one that ends at the CLI's 100,000-iteration cap (`"converged": false`,
# ROADMAP C9) is reported with its distance.  The default run takes the
# CPU tests' sizes (tests/test_torch_models_cli.py), where gbd's,
# apl1p's, usar's, aircond's and hydro's EFs converge; sizes', netdes'
# and battery's end at the cap there too (35-46 s each on the card), so
# they run with --full, which takes MODELS_CLI's sizes (where only
# usar's and aircond's EFs converge, on an H100)
MODELS_CLI_EF = {
    False: [("gbd", ["--num-scens", "5"]),
            ("apl1p", ["--num-scens", "6"]), ("usar", ["--num-scens", "4"]),
            ("aircond", ["--branching-factors", "2", "2"]),
            ("hydro", ["--branching-factors", "3", "3"])],
    True: [(name, flags) for name, flags, _ in MODELS_CLI],
}
CLI_EF_RTOL = 1e-4
# [usar_mip]: tests/test_models_zoo2.py::test_usar_integer_first_stage's
# instance and options, its node LPs capped at MIP_SMALL_NODE_MAX_ITERS
# (cut from BnBOptions' 8,000: 7,064 windows, 57-81 s on the card; the
# CPU run at 800 gives the same bracket in 1,771 windows)
USAR_MIP_INSTANCE = dict(num_depots=3, num_sites=5, time_horizon=4,
                         num_active_depots=1, seed=2)
USAR_MIP_SCENS = 3
# [admm]: the JAX tests' runs and bound (tests/test_battery_distr.py,
# tests/test_models_zoo2.py): within 5e-3 of the merged LP
ADMM_REGIONS, ADMM_STOCH_SCENS = 3, 3
ADMM_TOL = 5e-3
# stoch_distr capped at 30 PH iterations (cut from the JAX test's 400; it
# reaches conv 2e-4 at 62, and at 30 lies 1.5e-4 from the merged LP on
# the CPU); both runs' iter0 solves take ADMM_ITER0_WINDOWS windows (cut
# from 400: every lane is done long before, and on the CPU 50, 100 and
# 400 give the same bounds and iterates)
ADMM_STOCH_ITERS = 30
ADMM_ITER0_WINDOWS = 50


def model_specs(name, S=None, bfs=None, **kw):
    """(specs, tree) of a model of the port at S scenarios (or on the
    tree of branching factors bfs), as its CLI builds them."""
    import importlib
    mod = importlib.import_module(f"mpisppy_tpu_torch.models.{name}")
    tree = None
    if bfs is not None:
        S = math.prod(bfs)
        kw["branching_factors"] = tuple(bfs)
        tree = mod.make_tree(tuple(bfs))
    if name in ("gbd", "apl1p", "usar") and "num_scens" not in kw:
        kw["num_scens"] = S
    if name == "usar" and "instance" not in kw:
        kw["instance"] = mod.generate_instance()
    if name == "sizes":
        kw.setdefault("scenario_count", S)
        kw.setdefault("lp_relax", True)
    names = mod.scenario_names_creator(S)
    return [mod.scenario_creator(nm, **kw) for nm in names], tree


def model_batch(name, device, S=None, bfs=None, **kw):
    from mpisppy_tpu_torch.core import batch as batch_mod
    specs, tree = model_specs(name, S, bfs, **kw)
    return batch_mod.from_specs(specs, tree=tree, device=device)


def highs_ef(specs, tree=None, integer=False):
    """The scipy HiGHS optimum of the extensive form, built here in f64
    from the specs: block-diagonal scenario rows, and one
    nonanticipativity row for each nonant slot and each scenario that
    shares its tree node with an earlier one.  The LP relaxation unless
    `integer` (then the specs' integer columns are integer)."""
    import numpy as np
    import scipy.sparse as sps
    from scipy.optimize import Bounds, LinearConstraint, milp

    from mpisppy_tpu_torch.core.tree import two_stage_tree
    S, n = len(specs), specs[0].c.shape[0]
    idx = np.asarray(specs[0].nonant_idx, np.int64)
    tree = tree or two_stage_tree(S, len(idx))
    p = np.array([1.0 / S if sp.probability is None else sp.probability
                  for sp in specs])
    c = np.concatenate([p[s] * np.asarray(sp.c, float)
                        for s, sp in enumerate(specs)])
    A = sps.block_diag([sps.csr_matrix(sp.A) for sp in specs], format="csr")
    nos = tree.node_of_slot()
    rows, cols, vals, first = [], [], [], {}
    for s in range(S):
        for j, col in enumerate(idx):
            key = (j, int(nos[s, j]))
            if key in first:
                r = len(rows) // 2
                rows += [r, r]
                cols += [first[key] * n + col, s * n + col]
                vals += [1.0, -1.0]
            else:
                first[key] = s
    k = len(rows) // 2
    links = sps.csr_matrix((vals, (rows, cols)), shape=(k, S * n))
    cat = np.concatenate
    integrality = None
    if integer:
        integrality = cat([np.zeros(n) if sp.integer is None
                           else np.asarray(sp.integer, float)
                           for sp in specs])
    res = milp(c, constraints=LinearConstraint(
        sps.vstack([A, links]).tocsr(),
        cat([cat([sp.bl for sp in specs]), np.zeros(k)]),
        cat([cat([sp.bu for sp in specs]), np.zeros(k)])),
        bounds=Bounds(cat([sp.l for sp in specs]),
                      cat([sp.u for sp in specs])),
        integrality=integrality)
    if res.status != 0:
        raise AssertionError(f"highs_ef: scipy HiGHS failed: {res.message}")
    return float(res.fun)


def ef_bracket(label, outer, inner, ef_opt, slack=EF_SLACK):
    """Both bounds finite, outer <= EF* + slack and inner >= EF* - slack,
    slack = `slack` * max(1, |EF*|)."""
    tol = slack * max(1.0, abs(ef_opt))
    ok = math.isfinite(outer) and math.isfinite(inner) \
        and outer <= ef_opt + tol and inner >= ef_opt - tol
    phase(label, highs_ef=ef_opt, outer=outer, inner=inner,
          slack=f"{slack}*max(1,|EF*|)", brackets_ef=ok)
    if not ok:
        raise AssertionError(f"{label}: the bounds do not bracket the "
                             "HiGHS EF optimum")


def models_windows(dev):
    """[models_windows]: one window of each new dense shared-A shape,
    kernel against plain version (parity with its f32 floor), in f32 and
    bf16x3, in every design plan_window allows (the rule's, and
    streamed always): hydro on the (30, 30) tree, aircond
    on (3, 3, 2), gbd, sizes and usar at MODEL_WINDOW_SCENS, and
    eval_candidates_exact's K*S batch on sslp 15x45.  Prints each
    shape's route and resident layout (m_pad, n_pad).  Returns
    {(shape, mode, design): max_err}."""
    import types

    import numpy as np

    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.ops import pdhg_window
    S = MODEL_WINDOW_SCENS // MODEL_WINDOW_TILES

    def candidates():
        inst = sslp.synthetic_instance(SSLP_SERVERS, SSLP_CLIENTS, seed=0)
        cps = [sslp.synthetic_client_present(SSLP_CLIENTS, s)
               for s in range(EXACT_S)]
        xh = (np.random.RandomState(0).rand(EXACT_K, SSLP_SERVERS) < 0.5)
        _, qp = sslp.candidates_batch(inst, cps, xh.astype(float), dev)
        return types.SimpleNamespace(qp=qp)
    # (label, batch builder, tiles along the scenario axis)
    shapes = [("hydro", lambda: model_batch("hydro", dev, bfs=HYDRO_BFS), 1),
              ("aircond", lambda: model_batch("aircond", dev,
                                              bfs=AIRCOND_BFS), 1),
              ("gbd", lambda: model_batch("gbd", dev, S), MODEL_WINDOW_TILES),
              ("sizes", lambda: model_batch("sizes", dev, S),
               MODEL_WINDOW_TILES),
              ("usar", lambda: model_batch("usar", dev, S, lp_relax=True),
               MODEL_WINDOW_TILES),
              ("sslp_exact_candidates", candidates, 1)]
    limits = pdhg_window.card_limits(torch.cuda.current_device())
    errs = {}
    for label, build, reps in shapes:
        args = window_inputs(build(), done_every=7)
        if reps > 1:
            args = tiled(args, reps)
        qp, Sb = args[0], args[1].shape[0]
        for mode in ("f32", "bf16x3"):
            L = pdhg_window.resident_layout(mode, qp.m, qp.n)
            rule = pdhg_window.plan_window(mode, qp.m, qp.n, Sb, *limits)
            designs = ([rule.design] if rule.design != "streamed"
                       else []) + ["streamed"]
            for design in designs:
                plan = pdhg_window.plan_window(mode, qp.m, qp.n, Sb, *limits,
                                               design=design)
                err, k = parity(
                    args, mode, "models_windows", Sb, design=design,
                    floor=True, shape=label, m=qp.m, n=qp.n,
                    route=f"{plan.design}/T{plan.tile}/blocks{plan.blocks}",
                    rule=rule.design, m_pad=None if L is None else L.m_pad,
                    n_pad=None if L is None else L.n_pad)
                moved = float((k[0] - args[1]).abs().max()) > 0.0 \
                    and float((k[1] - args[2]).abs().max()) > 0.0
                if not moved:
                    raise AssertionError(f"models_windows: {label} window "
                                         "left x or y where it was")
                errs[label, mode, design] = err
        del qp, args
        torch.cuda.empty_cache()
    return errs


def hydro_wheel_dicts(batch, specs, tree, max_iterations,
                      iter_precision="bf16x3", hub_extra=None):
    """bench.py's bench_hydro wheel (see HYDRO_BFS) as (hub, spokes)."""
    import functools

    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.algos.ef import build_ef
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.extensions.rho_setters import SepRho
    from mpisppy_tpu_torch.ops import pdhg
    opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=8,
        pdhg=pdhg.PDHGOptions(tol=1e-6, restart_period=N_ITERS,
                              iter_precision=iter_precision))
    efp = build_ef(specs, tree=tree, device=batch.device)
    ef = {"ef_problem": efp, "n_windows": 20}
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 0.01,
                                      "spoke_sync_period": 5,
                                      **(hub_extra or {})}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions(
                              xhat_windows=0),
                          "extensions": functools.partial(
                              SepRho, multiplier=2.0)}}
    spokes = [{"spoke_class": spoke.EFOuterBound,
               "opt_kwargs": {"options": ef}},
              {"spoke_class": spoke.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke.EFXhatInnerBound,
               "opt_kwargs": {"options": ef}}]
    return hub, spokes


def spin(hub, spokes, device):
    """WheelSpinner(hub, spokes).spin(); returns the spinner and its wall
    seconds (after a synchronize on the card)."""
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    t0 = time.perf_counter()
    ws = WheelSpinner(hub, spokes).spin()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return ws, time.perf_counter() - t0


def hydro_small(dev):
    """[hydro_small]: the bench wheel on hydro (3, 3) on the card and on
    the CPU, both to 1%: their bounds agree to 1e-3 relative and both
    bracket the HiGHS EF optimum."""
    from mpisppy_tpu_torch.core import batch as batch_mod
    specs, tree = model_specs("hydro", bfs=HYDRO_SMALL_BFS)
    ef_opt = highs_ef(specs, tree)
    b = batch_mod.from_specs(specs, tree=tree, device=dev)
    g, g_s = spin(*hydro_wheel_dicts(b, specs, tree, HYDRO_MAX_ITERS), dev)
    c = CPU_HALVES.result("hydro_small")
    g_gap = g.spcomm.compute_gaps()[1]
    rel = max(abs(a - b) / abs(b) for a, b in (
        (g.BestOuterBound, c["outer"]), (g.BestInnerBound, c["inner"])))
    phase("hydro_small", bfs="x".join(map(str, HYDRO_SMALL_BFS)),
          gpu_iters=g.spcomm._iter, cpu_iters=c["iters"],
          outer=g.BestOuterBound, inner=g.BestInnerBound, rel_gap=g_gap,
          cpu_outer=c["outer"], cpu_inner=c["inner"],
          cpu_rel_gap=c["rel_gap"], max_rel_diff=rel, gpu_s=round(g_s, 2),
          cpu_s=round(c["s"], 2))
    ef_bracket("hydro_small", g.BestOuterBound, g.BestInnerBound, ef_opt)
    ef_bracket("hydro_small_cpu", c["outer"], c["inner"], ef_opt)
    if not (max(g_gap, c["rel_gap"]) <= 0.01 and rel <= 1e-3):
        raise AssertionError("hydro_small: no 1% certificate on the card "
                             "or the CPU, or their bounds disagree")


def hydro_wheel(dev, full=False):
    """[hydro_wheel], the slice's main path: bench_hydro's wheel on the
    card at (30, 30), 900 scenarios, in bf16x3, capped at
    HYDRO_WHEEL_ITERS[full] hub iterations (with `full` to its 1%
    certificate, which it must reach), with the launch counts
    set to 0 just before and read just after (K2 must have launched),
    its hub iterations 3-4 under the hub's --profile-dir session (the
    busy share read back through telemetry/deviceprof.py and
    roofline.py).  Its bounds must bracket the HiGHS EF optimum of the
    same 900-scenario batch.  Returns the launches by design."""
    import tempfile

    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.ops import pdhg_window
    from mpisppy_tpu_torch.telemetry import deviceprof, roofline
    specs, tree = model_specs("hydro", bfs=HYDRO_BFS)
    t0 = time.perf_counter()
    ef_opt = highs_ef(specs, tree)
    highs_s = time.perf_counter() - t0
    batch = batch_mod.from_specs(specs, tree=tree, device=dev)
    cap = HYDRO_WHEEL_ITERS[full]
    with tempfile.TemporaryDirectory() as prof:
        hub, spokes = hydro_wheel_dicts(
            batch, specs, tree, cap,
            hub_extra={"profile_dir": prof, "profile_iters": 2})
        reset_launches()
        ws, secs = spin(hub, spokes, dev)
        launches = dict(pdhg_window.run_window.launches)
        by_design = dict(pdhg_window.run_window.launches_by_design)
        cap_ = deviceprof.newest_capture(prof)
        busy = None if cap_ is None else roofline.busy_share(
            deviceprof.build_timeline(cap_))
    iters = ws.spcomm._iter
    outer, inner = ws.BestOuterBound, ws.BestInnerBound
    rel_gap = ws.spcomm.compute_gaps()[1]
    k2 = by_design.get("pdhg_window/bf16x3/resident", 0)
    # the first hub iteration with both bounds published
    first = next((r["iter"] for r in trace_rows(ws)
                  if math.isfinite(r["inner"]) and math.isfinite(r["outer"])),
                 None)
    phase("hydro_wheel", S=batch.num_scenarios,
          bfs="x".join(map(str, HYDRO_BFS)), iter_precision="bf16x3",
          iterations=iters, cap=cap, outer=outer, inner=inner,
          rel_gap=rel_gap, certified=rel_gap <= 0.01,
          seconds=round(secs, 2),
          s_per_hub_iter=round(secs / max(1, iters), 4),
          busy_share_profiled=None if busy is None else round(busy, 4),
          first_bounds_iter=first,
          k2_launches=k2, kernel_launches=launches["pdhg_window"],
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""),
          highs_ef=ef_opt, highs_s=round(highs_s, 2))
    ef_bracket("hydro_wheel", outer, inner, ef_opt)
    if k2 <= 0 or not busy:
        raise AssertionError("hydro_wheel: no K2 launch, or no device "
                             "activity in the profiled window")
    if (full or iters < cap) and rel_gap > 0.01:
        raise AssertionError("hydro_wheel: no 1% certificate")
    del ws, batch
    torch.cuda.empty_cache()
    return by_design


def aircond_wheel_dicts(batch, specs, tree, max_iterations=60):
    """tests/test_models_zoo.py's aircond wheel: PH hub (rho 1, 8
    subproblem windows, PDHG tol 1e-6) with the EF outer bound and the
    root-fixed EF inner bound, 30 windows each, to 1%."""
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.algos.ef import build_ef
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.ops import pdhg
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=max_iterations,
                            conv_thresh=0.0, subproblem_windows=8,
                            pdhg=pdhg.PDHGOptions(tol=1e-6))
    ef = {"ef_problem": build_ef(specs, tree=tree, device=batch.device),
          "n_windows": 30}
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 0.01}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch}}
    spokes = [{"spoke_class": spoke.EFOuterBound,
               "opt_kwargs": {"options": ef}},
              {"spoke_class": spoke.EFXhatInnerBound,
               "opt_kwargs": {"options": ef}}]
    return hub, spokes


def aircond_program_wheel(batch, max_iterations):
    """The fused wheel with the Lagrangian outer bound only (PH rho 1, 8
    subproblem windows, PDHG tol 1e-6, f32)."""
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.ops import pdhg
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=max_iterations,
                            conv_thresh=0.0, subproblem_windows=8,
                            pdhg=pdhg.PDHGOptions(tol=1e-6))
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 0.01}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions()}}
    spokes = [{"spoke_class": spoke.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}}]
    return hub, spokes


def aircond_phase(dev):
    """[aircond]: the (3, 3, 2) wheel with the EF spokes on the card and
    on the CPU, each bracketing the HiGHS EF optimum; then the aircond
    program's VirtualBatch at (25, 20, 20), 10,000 scenarios (its normal
    walk declares no row_draws: realize() draws the batch at every step
    entry), through the fused wheel with the Lagrangian outer bound: its
    realized data equal the materialized batch's bit for bit, its first
    hub iteration the same wheel's on the materialized batch to
    AIRCOND_FIRST_ITER_RTOL (run twice to show the run-to-run spread),
    then AIRCOND_PROGRAM_ITERS hub iterations.
    Returns the launches by design of the program's wheel."""
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import aircond
    from mpisppy_tpu_torch.ops import pdhg_window
    specs, tree = model_specs("aircond", bfs=AIRCOND_BFS)
    ef_opt = highs_ef(specs, tree)
    b = batch_mod.from_specs(specs, tree=tree, device=dev)
    ws, secs = spin(*aircond_wheel_dicts(b, specs, tree), dev)
    runs = (("aircond", "cuda", summary(ws, secs)),
            ("aircond_cpu", "cpu", CPU_HALVES.result("aircond")))
    del ws, b
    for label, d, r in runs:
        phase(label, bfs="x".join(map(str, AIRCOND_BFS)), device=d,
              iterations=r["iters"], outer=r["outer"], inner=r["inner"],
              rel_gap=r["rel_gap"], seconds=round(r["s"], 2))
        ef_bracket(label, r["outer"], r["inner"], ef_opt)
    S = math.prod(AIRCOND_PROGRAM_BFS)
    prog = aircond.scenario_program(S, seed=0,
                                    branching_factors=AIRCOND_PROGRAM_BFS)
    vb = scengen.virtual_batch(prog, device=dev)
    mat = scengen.materialize(prog, device=dev)
    real = vb.realize()
    same_data = all(torch.equal(getattr(real.qp, f), getattr(mat.qp, f))
                    for f in ("c", "q", "A", "bl", "bu", "l", "u"))
    del real
    first = {}
    for label, b in (("virtual", vb), ("materialized", mat),
                     ("materialized_again", mat)):
        ws, _ = spin(*aircond_program_wheel(b, 1), dev)
        first[label] = (ws.BestOuterBound, float(ws.opt.state.conv))
        del ws
    rel = max(abs(a - b) / max(1.0, abs(b)) for a, b in
              zip(first["virtual"], first["materialized"]))
    phase("aircond_program", S=S, realized_equals_materialized=same_data,
          first_iter_virtual=first["virtual"],
          first_iter_materialized=first["materialized"],
          first_iter_materialized_again=first["materialized_again"],
          max_rel_diff=rel, tol=AIRCOND_FIRST_ITER_RTOL)
    del mat
    if not same_data or rel > AIRCOND_FIRST_ITER_RTOL:
        raise AssertionError("aircond_program: the VirtualBatch's data or "
                             "first hub iteration differs from the "
                             "materialized batch's")
    reset_launches()
    ws, secs = spin(*aircond_program_wheel(vb, AIRCOND_PROGRAM_ITERS), dev)
    by_design = dict(pdhg_window.run_window.launches_by_design)
    phase("aircond_program", S=S, bfs="x".join(map(str,
                                                   AIRCOND_PROGRAM_BFS)),
          iterations=ws.spcomm._iter, outer=ws.BestOuterBound,
          seconds=round(secs, 2),
          persistent_bytes=vb.persistent_bytes(),
          materialized_bytes=vb.materialized_bytes(),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not math.isfinite(ws.BestOuterBound) \
            or pdhg_window.run_window.launches["pdhg_window"] <= 0:
        raise AssertionError("aircond_program: no outer bound or no "
                             "window kernel launch")
    return by_design


def models_cli(dev, full=False):
    """[models_cli]: generic_cylinders.main in this process, on the card,
    for each model of MODELS_CLI with the fused wheel, the Lagrangian and
    x̂-x̄ spokes capped at 1 hub iteration (its route printed), then each
    model of MODELS_CLI_EF[full] with --EF against the HiGHS optimum of
    its extensive form.  Returns the launches by design of the wheel
    runs."""
    import contextlib
    import importlib
    import io

    from mpisppy_tpu_torch import generic_cylinders
    from mpisppy_tpu_torch.ops import pdhg
    total = {}
    for name, flags, box in MODELS_CLI:
        args = ["--module-name", f"mpisppy_tpu_torch.models.{name}",
                *flags]
        result, _, by_design, ws = cli_run(f"models_cli_{name}",
                                           args + MODELS_CLI_WHEEL,
                                           box_kernel=box)
        merge_launches(total, by_design)
        qp, S = ws.opt.batch.qp, ws.opt.batch.num_scenarios
        engine = pdhg.window_engine(qp, "cuda")
        phase(f"models_cli_{name}", engine=engine,
              route=plan_line(qp, S) if engine == "kernel" else "plain",
              a=type(qp.A).__name__, a_shape="x".join(map(str, qp.A.shape)))
        del ws, qp
        torch.cuda.empty_cache()
    for name, flags in MODELS_CLI_EF[full]:
        args = ["--module-name", f"mpisppy_tpu_torch.models.{name}",
                *flags]
        mod = importlib.import_module(f"mpisppy_tpu_torch.models.{name}")
        names, kwargs, tree = generic_cylinders._model_plumbing(
            generic_cylinders._parse_args(mod, args), mod)
        ef_opt = highs_ef([mod.scenario_creator(nm, **kwargs)
                           for nm in names], tree)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            generic_cylinders.main(args + ["--EF"])
        torch.cuda.synchronize()
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        rel = abs(res["EF_objective"] - ef_opt) / max(1.0, abs(ef_opt))
        phase(f"models_cli_{name}_ef", S=len(names),
              ef_objective=res["EF_objective"], converged=res["converged"],
              highs_ef=ef_opt, rel_diff=rel,
              tol=CLI_EF_RTOL if res["converged"] else "at the cap (C9)",
              wall_s=round(time.perf_counter() - t0, 2))
        if res["converged"] and rel > CLI_EF_RTOL:
            raise AssertionError(f"models_cli_{name}: --EF off the HiGHS "
                                 "optimum")
        torch.cuda.empty_cache()
    return total


def usar_mip(dev):
    """[usar_mip]: certified_mip_gap on the JAX test's usar instance (3
    depots, 5 sites, horizon 4, one active depot, 3 scenarios) with its
    options (node LPs capped, USAR_MIP_INSTANCE), on the card: the bracket contains scipy's MILP optimum of
    the extensive form and the incumbent activates exactly one depot."""
    import numpy as np

    from mpisppy_tpu_torch.algos import mip as mip_mod
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import usar
    from mpisppy_tpu_torch.ops import bnb, pdhg
    inst = usar.generate_instance(**USAR_MIP_INSTANCE)
    specs, _ = model_specs("usar", USAR_MIP_SCENS, instance=inst)
    opt = highs_ef(specs, integer=True)
    b = batch_mod.from_specs(specs, device=dev)
    t0 = time.perf_counter()
    res = mip_mod.certified_mip_gap(
        b, ph_options=ph_mod.PHOptions(
            default_rho=5.0, max_iterations=60, conv_thresh=1e-3,
            pdhg=pdhg.PDHGOptions(tol=1e-6)),
        opts=bnb.BnBOptions(max_rounds=120, lp=mip_node_lp(
            MIP_SMALL_NODE_MAX_ITERS)), dd_nodes=4)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    depots = float(np.round(res.xhat[:inst["num_depots"]]).sum())
    phase("usar_mip", S=USAR_MIP_SCENS, inner=res.inner, outer=res.outer,
          milp=opt, depots_active=depots, seconds=round(secs, 2))
    in_bracket("usar_mip", res.inner, res.outer, opt)
    if depots != 1.0:
        raise AssertionError("usar_mip: the incumbent does not activate "
                             "exactly one depot")


def admm_phase(dev):
    """[admm]: distr (3 regions) through AdmmWrapper and stoch_distr (3
    regions x 3 scenarios) through Stoch_AdmmWrapper, PH on the card
    with the JAX tests' options, each within ADMM_TOL of the merged LP
    (global_lp_oracle)."""
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.models import distr, stoch_distr
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.utils.admmWrapper import AdmmWrapper
    from mpisppy_tpu_torch.utils.stoch_admmWrapper import Stoch_AdmmWrapper
    R = ADMM_REGIONS
    data = distr.region_data(R, seed=1)
    w = AdmmWrapper({}, distr.scenario_names_creator(R),
                    lambda nm, **kw: distr.scenario_creator(nm, data=data),
                    distr.consensus_vars_creator(R, data))
    runs = [("admm_distr", w.make_batch(dev), ph_mod.PHOptions(
        max_iterations=600, default_rho=2.0, conv_thresh=1e-7,
        subproblem_windows=10, iter0_windows=ADMM_ITER0_WINDOWS),
        distr.global_lp_oracle(data))]
    data = distr.region_data(R, seed=2)
    stoch_names = stoch_distr.stoch_scenario_names_creator(ADMM_STOCH_SCENS)
    sw = Stoch_AdmmWrapper(
        {}, stoch_distr.admm_subproblem_names_creator(R), stoch_names,
        lambda snm, rnm, **kw: stoch_distr.scenario_creator(snm, rnm,
                                                            data=data),
        stoch_distr.consensus_vars_creator(R, data))
    runs.append(("admm_stoch_distr", sw.make_batch(dev), ph_mod.PHOptions(
        default_rho=2.0, max_iterations=ADMM_STOCH_ITERS, conv_thresh=2e-4,
        subproblem_windows=10, iter0_windows=ADMM_ITER0_WINDOWS,
        pdhg=pdhg.PDHGOptions(tol=1e-7, restart_period=N_ITERS)),
        stoch_distr.global_lp_oracle(data, stoch_names)))
    for label, b, opts, ref in runs:
        t0 = time.perf_counter()
        conv, eobj, _ = ph_mod.PH(opts, b).ph_main()
        torch.cuda.synchronize()
        err = abs(eobj - ref) / (1.0 + abs(ref))
        phase(label, S=b.num_scenarios, device=b.device.type,
              a=type(b.qp.A).__name__, conv=conv, eobj=eobj, global_lp=ref,
              rel_err=err, tol=ADMM_TOL,
              seconds=round(time.perf_counter() - t0, 2))
        if b.device.type != "cuda" or err > ADMM_TOL:
            raise AssertionError(f"{label}: off the merged LP")


def exact_candidates(dev):
    """[exact_candidates]: eval_candidates_exact on the card (its K*S LP
    through the window kernel) against the same call on the CPU."""
    import numpy as np

    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.ops import pdhg_window
    inst = sslp.synthetic_instance(SSLP_SERVERS, SSLP_CLIENTS, seed=0)
    cps = [sslp.synthetic_client_present(SSLP_CLIENTS, s)
           for s in range(EXACT_RUN_S)]
    xh = (np.random.RandomState(1).rand(EXACT_RUN_K, SSLP_SERVERS)
          < 0.5).astype(float)
    reset_launches()
    t0 = time.perf_counter()
    card = sslp.eval_candidates_exact(inst, cps, xh, device=dev)
    secs = time.perf_counter() - t0
    by_design = dict(pdhg_window.run_window.launches_by_design)
    cpu = sslp.eval_candidates_exact(inst, cps, xh, device="cpu")
    rel = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, cpu))
    phase("exact_candidates", K=EXACT_RUN_K, S=EXACT_RUN_S,
          values=json.dumps(card), cpu_values=json.dumps(cpu),
          max_rel_diff=rel, seconds=round(secs, 2),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not by_design or rel > 1e-3:
        raise AssertionError("exact_candidates: no window kernel launch, "
                             "or the card's values differ from the CPU's")
    return by_design


def models_path(dev, full=False):
    """The models phases ([models_windows] first).  Returns
    the launches by design of the runs that go on the kernels line."""
    t0 = time.perf_counter()
    models_windows(dev)
    hydro_small(dev)
    total = hydro_wheel(dev, full)
    merge_launches(total, aircond_phase(dev))
    merge_launches(total, models_cli(dev, full))
    merge_launches(total, exact_candidates(dev))
    usar_mip(dev)
    admm_phase(dev)
    phase("models_path", seconds=round(time.perf_counter() - t0, 2))
    return total


def resilience_path(dev, sync):
    """The checkpoint and preemption phases.  Returns the launches by
    design of [checkpoint_headline]."""
    t0 = time.perf_counter()
    total = checkpoint_headline(dev, sync)
    torch.cuda.empty_cache()
    preempt_cli()
    phase("resilience_path", seconds=round(time.perf_counter() - t0, 2))
    return total


# The extensions, convergers and rho/W/x̄ utilities, driven
# through the CLI on the card ([ext_*]).  [ext_cli_headline] is the
# headline's CLI flags with the gradient rho (updated at hub iterations
# 2, 4 and 6), the primal-dual converger and the W/x̄/rho files, capped
# at EXT_CLI_HEADLINE_ITERS hub iterations; [ext_cli_warm] reruns it from
# those files for EXT_CLI_WARM_ITERS.  The gradient rho takes the
# scenario-independent denominator E[max(|x - x̄|, 1)]: with the
# per-scenario |x - x̄| (the default) rho grows as x reaches x̄, to
# 2.3e5-3.1e6 by hub iteration 6 at S=10,000, and W's f32 slot means
# drift to 0.54 against the W check's 7.1e-3, so the file would not
# reload (both packages; ROADMAP.md C10)
EXT_CLI_HEADLINE_ITERS = 6
EXT_CLI_WARM_ITERS = 2
EXT_GRAD_FLAGS = ["--grad-rho", "--grad-rho-update-interval", "2",
                  "--grad-rho-indep-denom", "--use-primal-dual-converger"]
# [ext_sensi_mult]: sslp 5x15 at S=64 (the [wheel_small] shape) with
# --sensi-rho, then --mult-rho, on the card and in the CPU worker
EXT_SMALL = ["--module-name", "mpisppy_tpu_torch.models.sslp",
             "--n-servers", "5", "--n-clients", "15", "--num-scens", "64",
             "--sslp-lp-relax", "--default-rho", "20", "--fused-wheel",
             "--lagrangian", "--xhatxbar", "--rel-gap", "0.01",
             "--max-iterations", "10"]
EXT_SMALL_RHO = {"ext_sensi": ["--sensi-rho"], "ext_mult": ["--mult-rho"]}
# [ext_grad_xhat]: find_grad_cost's fixed-nonant solve at S=1,000 (to tol
# 1e-6, capped at EXT_GRAD_MAX_ITERS PDHG iterations: 100 windows), and
# XhatClosest on [ext_cli_headline]'s wheel at S=10,000
EXT_GRAD_SCENS = 1_000
EXT_GRAD_MAX_ITERS = 4_000
# [ext_bundles]: proper bundles of EXT_BUNDLE_SIZE scenarios at S=1,000,
# 2 hub iterations, written as pickles and read back
EXT_BUNDLE_SIZE = 10
EXT_BUNDLE = SSLP_15_45 + ["--num-scens", "1000", "--scenarios-per-bundle",
                           str(EXT_BUNDLE_SIZE), "--default-rho", "20",
                           "--fused-wheel", "--lagrangian",
                           "--max-iterations", "2"]


def ext_small_cli(name, device):
    """[ext_sensi_mult]'s CLI run `name` on `device`: (summary, final
    rho), the CLI's JSON line swallowed."""
    import contextlib
    import io

    from mpisppy_tpu_torch import generic_cylinders
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ws = generic_cylinders.main(EXT_SMALL + EXT_SMALL_RHO[name]
                                    + ["--device", device])
    if device != "cpu":
        torch.cuda.synchronize()
    out = summary(ws, time.perf_counter() - t0)
    out["rho"] = ws.opt.state.rho.cpu().numpy().tolist()
    return out, ws


class PlainWindows:
    """Within the block every window on the card runs the kernel's plain
    PyTorch version (run_window_reference), and no launch is counted."""

    def __enter__(self):
        from mpisppy_tpu_torch.ops import pdhg_window
        self.real = pdhg_window.run_window

        def plain(p, x, y, xs, ys, tau, sigma, done, n_iters,
                  precision=None, synth=None, design=None):
            return pdhg_window.run_window_reference(
                p, x, y, xs, ys, tau, sigma, done, n_iters,
                precision=precision, synth=synth)
        pdhg_window.run_window = plain
        return self

    def __exit__(self, *exc):
        from mpisppy_tpu_torch.ops import pdhg_window
        pdhg_window.run_window = self.real
        return False


def read_w_file(path, names, N):
    """A W file (scenario_name,slot,value rows) as an (S, N) float32
    array in `names`' order."""
    import numpy as np
    index = {nm: s for s, nm in enumerate(names)}
    W = np.full((len(names), N), np.nan, np.float32)
    with open(path) as f:
        for line in f:
            nm, i, v = line.rsplit(",", 2)
            W[index[nm], int(i)] = float(v)
    return W


def ext_cli_headline(d):
    """[ext_cli_headline]: CLI_HEADLINE (sslp 15x45, S=10,000, bf16x3, the
    four fused spokes) with the gradient rho every 2 hub iterations
    (EXT_GRAD_FLAGS), the primal-dual converger and
    --W-fname/--Xbar-fname/--rho-file-out,
    capped at EXT_CLI_HEADLINE_ITERS hub iterations.  K2 must launch, rho
    must move off 20 at the first update (hub iteration 2), the rho file
    must hold 15 finite positive rhos (the final state's), the W file the
    final W (bit for bit) with p-weighted slot means within the JAX
    check's 1e-4 (1 + max|W|), the x̄ file the final x̄, and outer <=
    inner within the hub's bound slack.  Returns (the spinner, launches
    by design, the three files)."""
    import os

    import numpy as np

    from mpisppy_tpu_torch.extensions import rho_setters
    from mpisppy_tpu_torch.utils import rho_utils
    w, x, r = (os.path.join(d, f) for f in ("w.csv", "x.csv", "rho.csv"))
    updates = []
    real = rho_setters._set_rho

    def recording(ph, rho_new):
        updates.append((ph._iter, np.array(rho_new, np.float64)))
        real(ph, rho_new)
    rho_setters._set_rho = recording
    try:
        result, _, by_design, ws = cli_run("ext_cli_headline", cli_capped(
            CLI_HEADLINE, "--max-iterations", EXT_CLI_HEADLINE_ITERS)
            + EXT_GRAD_FLAGS + ["--W-fname", w, "--Xbar-fname", x,
                                "--rho-file-out", r])
    finally:
        rho_setters._set_rho = real
    st, batch = ws.opt.state, ws.opt.batch
    N = batch.num_nonants
    with open(r) as f:
        n_rows = sum(1 for _ in f) - 1
    rho = rho_utils.rhos_from_csv(r, N)
    W = read_w_file(w, ws.opt.scenario_names, N)
    p = batch.p.cpu().numpy().astype(np.float64)
    wbar = np.abs((p[:, None] * W).sum(0)).max()
    w_tol = 1e-4 * (1.0 + np.abs(W).max())
    xb = np.loadtxt(x, delimiter=",")
    xbar_file = np.zeros(tuple(st.xbar_nodes.shape), np.float32)
    xbar_file[xb[:, 0].astype(int), xb[:, 1].astype(int)] = xb[:, 2]
    first_iter, first_rho = updates[0] if updates else (None, None)
    outer, inner = result["outer_bound"], result["inner_bound"]
    slack = HUB_BOUND_SLACK * max(1.0, abs(inner or 0.0))
    conv = ws.opt.converger_object
    phase("ext_cli_headline", S=batch.num_scenarios,
          rho_updates_at=json.dumps([it for it, _ in updates]),
          first_update_rho_min=None if first_rho is None
          else float(first_rho.min()),
          first_update_rho_max=None if first_rho is None
          else float(first_rho.max()),
          final_rho_min=float(rho.min()), final_rho_max=float(rho.max()),
          rho_file_rows=n_rows, w_file_rows=int(np.isfinite(W).sum()),
          w_slot_mean_max=float(wbar), w_check_tol=float(w_tol),
          w_file_equals_state=bool(np.array_equal(W, st.W.cpu().numpy())),
          xbar_file_equals_state=bool(np.array_equal(
              xbar_file, st.xbar_nodes.cpu().numpy())),
          converger_checks=len(conv.trace),
          converger_last=json.dumps([float(v) for v in conv.trace[-1]])
          if conv.trace else None,
          k2_launches=by_design.get(K2_KEY, 0))
    checks = {
        "k2": by_design.get(K2_KEY, 0) > 0,
        "rho_moved_at_2": first_iter == 2 and bool(np.any(first_rho != 20.0)),
        "rho_file": n_rows == N == 15 and bool(np.isfinite(rho).all())
        and bool((rho > 0).all()) and np.array_equal(rho,
                                                     st.rho.cpu().numpy()),
        "w_file": np.array_equal(W, st.W.cpu().numpy()),
        "w_check": bool(wbar <= w_tol),
        "xbar_file": np.array_equal(xbar_file, st.xbar_nodes.cpu().numpy()),
        "converger": len(conv.trace) >= EXT_CLI_HEADLINE_ITERS,
        "bounds": inner is None or outer <= inner + slack}
    phase("ext_cli_headline", checks=json.dumps(checks).replace(" ", ""))
    if not all(checks.values()):
        raise AssertionError("ext_cli_headline: failed "
                             f"{[k for k, v in checks.items() if not v]}")
    return ws, by_design, (w, x, r)


def ext_cli_warm(files):
    """[ext_cli_warm]: CLI_HEADLINE from [ext_cli_headline]'s files
    (--rho-file-in, --init-W-fname, --init-Xbar-fname) for
    EXT_CLI_WARM_ITERS hub iterations.  As the JAX package does it, the
    file's rho is the PH object's starting rho (its Iter0 state carries it),
    and W and x̄ are installed right after Iter0: the state then holds the
    files' values bit for bit.  Returns the launches by design."""
    import numpy as np

    from mpisppy_tpu_torch.extensions import wxbar_io
    from mpisppy_tpu_torch.utils import rho_utils
    w, x, r = files
    seen = {}
    real = wxbar_io.WXBarReader.post_iter0

    def probe(self):
        seen["rho_iter0"] = self.opt.state.rho.cpu().numpy()
        real(self)
        st = self.opt.state
        seen.update(W=st.W.cpu().numpy(), xbar=st.xbar_nodes.cpu().numpy(),
                    rho=st.rho.cpu().numpy())
    wxbar_io.WXBarReader.post_iter0 = probe
    try:
        result, _, by_design, ws = cli_run("ext_cli_warm", cli_capped(
            CLI_HEADLINE, "--max-iterations", EXT_CLI_WARM_ITERS)
            + ["--rho-file-in", r, "--init-W-fname", w,
               "--init-Xbar-fname", x])
    finally:
        wxbar_io.WXBarReader.post_iter0 = real
    N = ws.opt.batch.num_nonants
    rho = rho_utils.rhos_from_csv(r, N).astype(np.float32)
    W = read_w_file(w, ws.opt.scenario_names, N)
    xb = np.loadtxt(x, delimiter=",")
    xbar = np.zeros_like(seen.get("xbar", np.zeros((1, N), np.float32)))
    xbar[xb[:, 0].astype(int), xb[:, 1].astype(int)] = xb[:, 2]
    ok = {"rho_iter0": np.array_equal(seen.get("rho_iter0"), rho),
          "W": np.array_equal(seen.get("W"), W),
          "xbar": np.array_equal(seen.get("xbar"), xbar),
          "rho": np.array_equal(seen.get("rho"), rho)}
    phase("ext_cli_warm", installed=json.dumps(ok).replace(" ", ""),
          k2_launches=by_design.get(K2_KEY, 0))
    if not (all(ok.values()) and by_design.get(K2_KEY, 0) > 0):
        raise AssertionError("ext_cli_warm: the files' rho, W or x̄ not "
                             "installed as read, or no K2 launch")
    return by_design


def ext_sensi_mult():
    """[ext_sensi_mult]: EXT_SMALL with --sensi-rho, then --mult-rho, on
    the card (launch counts read around each run) and in the CPU worker:
    their bounds agree to 1e-3 relative (--mult-rho: to HUB_BOUND_SLACK,
    its rho doubles every 2 iterations, to 32 times the start by the
    10th, and each doubling scales the f32 differences of x - x̄ that W
    carries; 7.1e-4 on an H100); SensiRho's rho moved off 20,
    MultRhoUpdater's is 20 times a power of 2 on both sides.  Returns the
    launches by design."""
    from mpisppy_tpu_torch.ops import pdhg_window
    total = {}
    for name in EXT_SMALL_RHO:
        reset_launches()
        g, ws = ext_small_cli(name, "cuda")
        merge_launches(total, pdhg_window.run_window.launches_by_design)
        launches = sum(pdhg_window.run_window.launches.values())
        c = CPU_HALVES.result(name)
        pairs = [(g["outer"], c["outer"])]
        if math.isfinite(c["inner"]) or math.isfinite(g["inner"]):
            pairs.append((g["inner"], c["inner"]))
        rel = max(abs(a - b) / abs(b) for a, b in pairs)
        rho_rel = max(abs(a - b) / abs(b) for a, b in zip(g["rho"],
                                                          c["rho"]))
        phase(name, S=ws.opt.batch.num_scenarios, hub_iters=g["iters"],
              cpu_hub_iters=c["iters"], outer=g["outer"],
              inner=g["inner"], cpu_outer=c["outer"], cpu_inner=c["inner"],
              max_rel_diff=rel, tol=1e-3 if name == "ext_sensi"
              else HUB_BOUND_SLACK, rho=json.dumps(g["rho"][:3]),
              rho_max_rel_diff_vs_cpu=rho_rel, kernel_launches=launches,
              card_s=round(g["s"], 2), cpu_s=round(c["s"], 2))
        moved = (any(v != 20.0 for v in g["rho"]) if name == "ext_sensi"
                 else all(math.log2(v / 20.0) % 1 == 0 and v > 20.0
                          for v in g["rho"] + c["rho"]))
        tol = 1e-3 if name == "ext_sensi" else HUB_BOUND_SLACK
        if not (rel <= tol and moved and launches > 0
                and ws.opt.batch.device.type == "cuda"):
            raise AssertionError(f"{name}: card and CPU bounds disagree, "
                                 "rho not set as the extension sets it, or "
                                 "no kernel launch")
        del ws
    return total


def ext_grad_xhat(dev, ws):
    """[ext_grad_xhat]: find_grad_cost on sslp 15x45 at EXT_GRAD_SCENS
    scenarios (nonants fixed at all servers open, tol 1e-6, capped at
    EXT_GRAD_MAX_ITERS iterations) through K1, then again with every
    window in the plain version on the card: gradient costs within 1e-4
    of the scale, the fixed-nonant solves' objectives within 1e-3
    relative.  Then XhatClosest on [ext_cli_headline]'s wheel `ws`
    (S=10,000): the closest scenario's x̂ evaluated through the window
    kernel, its launches counted, its value (where the evaluation
    certifies x̂ feasible) at or above the outer bound.
    Returns the launches by design."""
    import numpy as np

    from mpisppy_tpu_torch.extensions.xhatclosest import XhatClosest
    from mpisppy_tpu_torch.ops import pdhg, pdhg_window
    from mpisppy_tpu_torch.utils import gradient
    batch = sslp_batch(EXT_GRAD_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    xhat = np.ones(batch.num_nonants)
    opts = pdhg.PDHGOptions(tol=1e-6, max_iters=EXT_GRAD_MAX_ITERS)
    solves = []
    real_solve = pdhg.solve

    def kept(p, o=pdhg.PDHGOptions(), state=None):
        st = real_solve(p, o, state)
        solves.append(float(batch.expectation(batch.objective(st.x))))
        return st
    pdhg.solve = kept
    try:
        reset_launches()
        t0 = time.perf_counter()
        c_k = gradient.find_grad_cost(batch, xhat, opts)
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
        total = dict(pdhg_window.run_window.launches_by_design)
        k1 = total.get("pdhg_window/f32/resident", 0)
        with PlainWindows():
            t0 = time.perf_counter()
            c_p = gradient.find_grad_cost(batch, xhat, opts)
            torch.cuda.synchronize()
            p_s = time.perf_counter() - t0
    finally:
        pdhg.solve = real_solve
    err = float(np.abs(c_k - c_p).max())
    scale = float(np.abs(c_p).max())
    obj_rel = abs(solves[0] - solves[1]) / max(1.0, abs(solves[1]))
    phase("ext_grad_xhat", part="find_grad_cost", S=batch.num_scenarios,
          max_iters=EXT_GRAD_MAX_ITERS, k1_launches=k1,
          max_abs_err=err, scale=scale, objective=solves[0],
          plain_objective=solves[1], objective_rel_diff=obj_rel,
          kernel_s=round(k_s, 3), plain_s=round(p_s, 3))
    if not (k1 > 0 and err <= 1e-4 * max(1.0, scale) and obj_rel <= 1e-3):
        raise AssertionError("ext_grad_xhat: find_grad_cost launched no "
                             "K1, or the kernel's costs or solve disagree "
                             "with the plain window's")
    del batch
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.perf_counter()
    xc = XhatClosest(ws.opt)
    obj, who = xc.xhat_closest_to_xbar()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_design = dict(pdhg_window.run_window.launches_by_design)
    merge_launches(total, by_design)
    outer = ws.BestOuterBound
    phase("ext_grad_xhat", part="xhat_closest", S=ws.opt.batch.num_scenarios,
          scenario=who["ROOT"], value=obj, outer=outer,
          seconds=round(secs, 3),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    # at hub iteration 6 the closest scenario's x̂ is fractional, and its
    # evaluation (the hub's bf16x3 options, tol 1e-6, 20,000 iterations)
    # does not certify every scenario feasible: no value (as on the CPU)
    if not (sum(by_design.values()) > 0 and (obj is None or (
            math.isfinite(obj)
            and obj >= outer - HUB_BOUND_SLACK * max(1.0, abs(outer))))):
        raise AssertionError("ext_grad_xhat: XhatClosest evaluated without "
                             "the window kernel, or its value lies below "
                             "the outer bound")
    return total


def ext_bundles():
    """[ext_bundles]: EXT_BUNDLE through the CLI, its 100 proper bundles
    written with --pickle-bundles-dir, then read back with
    --unpickle-bundles-dir: each bundle the EF of 10 scenarios (15
    shared nonants + 10 x 690 recourse columns, 600 rows), the batch an
    ELL matrix (one sparse matrix per bundle; sslp's are equal in value,
    so their values are shared), so no window kernel launches (the plain
    ELL iteration, as in the JAX package); both runs give the same hub
    rows."""
    import os
    import tempfile

    from mpisppy_tpu_torch.ops.sparse import EllMatrix
    with tempfile.TemporaryDirectory() as d:
        a, _, _, wa = cli_run("ext_bundles", EXT_BUNDLE + [
            "--pickle-bundles-dir", d], box_kernel=False)
        pickles = len([f for f in os.listdir(d) if f.endswith(".pkl")])
        rows_a = rows_minus_t(wa)
        qp = wa.opt.batch.qp
        shape = (wa.opt.batch.num_scenarios, qp.m, qp.n)
        ell = isinstance(qp.A, EllMatrix)
        vals = list(qp.A.vals.shape) if ell else None
        del wa, qp
        torch.cuda.empty_cache()
        b, _, _, wb = cli_run("ext_bundles_unpickled", EXT_BUNDLE + [
            "--unpickle-bundles-dir", d], box_kernel=False)
        rows_b = rows_minus_t(wb)
    S = 1000 // EXT_BUNDLE_SIZE
    phase("ext_bundles", bundles=shape[0], rows=shape[1], cols=shape[2],
          ell=ell, ell_vals=json.dumps(vals), pickles=pickles,
          same_rows=rows_a == rows_b, hub_rows=len(rows_a),
          pickled_s=round(a["wall_s"], 2),
          unpickled_s=round(b["wall_s"], 2))
    if not (shape == (S, EXT_BUNDLE_SIZE * 60,
                      SSLP_SERVERS + EXT_BUNDLE_SIZE * 690)
            and ell and pickles == S and rows_a == rows_b):
        raise AssertionError("ext_bundles: wrong bundle shape, not ELL, "
                             "pickles missing, or the unpickled run's rows "
                             "differ")


def ext_cli_headline_alone(dev):
    """--only ext_cli_headline: [ext_cli_headline], [ext_grad_xhat] and
    [ext_cli_warm] (the phases that share its wheel and files)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ws, _, files = ext_cli_headline(d)
        ext_grad_xhat(dev, ws)
        del ws
        ext_cli_warm(files)


def ext_path(dev, sync):
    """The slice-14 phases.  Returns their launches by design."""
    import tempfile
    t0 = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as d:
        ws, by_design, files = ext_cli_headline(d)
        merge_launches(total, by_design)
        merge_launches(total, ext_grad_xhat(dev, ws))
        del ws
        torch.cuda.empty_cache()
        merge_launches(total, ext_cli_warm(files))
    torch.cuda.empty_cache()
    merge_launches(total, ext_sensi_mult())
    ext_bundles()
    torch.cuda.empty_cache()
    phase("ext_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return total


# --------------------------------------------------------------------------
# Slice 15: confidence intervals and the rolling horizon
# --------------------------------------------------------------------------
CI_ZHAT_SAMPLES = 3                   # batches of HEADLINE_SCENS scenarios
CI_ZHAT_TOL, CI_ZHAT_CAP = 1e-5, 20_000   # f32; at most 500 windows
# [ci_mmw]: tools/ci_jax_reference.py's sizes, seeds and options (the
# sampled EF of 9 sslp 15x45 scenarios is dense, 660 x 6,345, and one
# streamed scenario's vectors fit a block's shared memory; at 10 they
# do not, and the EF would take the plain iteration).  MMW_TOL and
# MMW_CAP are the port's CI default (ciutils.DEFAULT_OPTS), which its
# MMWConfidenceIntervals always uses: the phase checks that they agree
MMW_BATCH, MMW_BATCHES = 9, 3
MMW_TOL, MMW_CAP = 1e-6, 20_000
MMW_XHAT = [0.7222141080547162, 9.493873862145507e-10, 0.0,
            0.3474066375724128, 0.9999970434231502, 1.5291972692662236e-06,
            0.7287810859230144, 0.027076254831271757, 0.1694581566335552,
            0.9446370588312444, 0.38981383080728943, 0.18643116153643607,
            0.004422107454674035, 5.178908119367865e-09,
            0.21186549569433438]
MMW_JAX = {"Glist": [4.440675556631618, 4.418886005688023,
                     2.1406385793170557],
           "Gbar": 3.6667333805455655, "std": 1.0791486468153477,
           "gap_inner_bound": 5.486020940696275}
MMW_SCALE = 283.3250160133881         # |E f(x̂)| of the first batch
CI_RTOL = 1e-3
CI_EF_ROUTE_WINDOWS = 100     # [ci_ef_route]: the same windows both ways
# [ci_seq]: farmer, an EF x̂ generator, knobs that stop in a few steps
CI_SEQ_KNOBS = {"BM": dict(BM_h=1.75, BM_hprime=0.3, BM_eps=200.0,
                           BM_eps_prime=40.0, confidence_level=0.9),
                "BPL": dict(BPL_eps=600.0, BPL_c0=10,
                            confidence_level=0.9)}
CI_SEQ_SCENS, CI_SEQ_MAXIT = 10, 8
CI_SEQ_TOL, CI_SEQ_EF_CAP = 1e-6, 20_000     # the x̂ generator's EF
# [ci_mstage]: aircond through its scengen program (tools/ci_jax_reference.py)
MSTAGE_BFS = (3, 3, 2)
MSTAGE_XHAT = (200.0, 0.0)
MSTAGE_TREES, MSTAGE_SEED = 3, 101
MSTAGE_TOL, MSTAGE_CAP = 1e-6, 20_000
MSTAGE_JAX = {"G": 69.42533895704487, "s": 33.26155985625671, "seed": 194,
              "zhats": [628.4479785230425, 775.0313527848984,
                        838.6282282935249], "zhat_seed": 194}
MSTAGE_RTOL = 1e-4
# [mpc_ccopf]: the (100,100) tree through the horizon's extra_args (after
# the recipe's --num-scens 9, so the later value must win); the (3,3)
# horizon against tools/mpc_jax_reference.py's JAX driver, given the
# port's --convthresh 0 (the horizon's recipe stops only on the gap,
# ROADMAP C1)
MPC_STEPS = 3
# [mpc_ccopf] at (100,100): 2 windows of at most 5 hub iterations (cut
# from 3 windows when the recipe began to stop only on the gap: window 0
# then ran 201 hub iterations in 390.7 s on the card with no inner bound)
MPC_CCOPF_STEPS = 2
MPC_CCOPF_ARGS = ("--branching-factors", "100", "100", "--num-scens",
                  str(CCOPF_BFS[0] * CCOPF_BFS[1]), "--max-iterations", "5")
MPC_CCOPF_SMALL_JAX = [
    {"step": 0, "outer": 71.77212524414062, "inner": 71.77219394929853,
     "iterations": 2, "warm": False},
    {"step": 1, "outer": 83.09888458251953, "inner": 83.10305287968367,
     "iterations": 3, "warm": True},
    {"step": 2, "outer": 82.66729736328125, "inner": 82.6690691257827,
     "iterations": 3, "warm": True}]
MPC_RTOL = 1e-4
MPC_UC_STEP = 1
# the JAX CLI's outer bound at window MPC_UC_STEP and at window 0
# (tools/mpc_jax_reference.py)
MPC_UC_JAX = {"outer_bound": 18076.2421875, "iterations": 2,
              "outer_bound_step0": 17994.18359375}
# At 2 hub rows the outer bound comes from capped windows of the first W
# and is ill-conditioned in f32 rounding: a 1-ulp change of the demand
# moves the port's CPU bound by up to 3.2e-3 (tools/uc_mpc_rounding.py),
# so the card's plain iteration, which sums in another order, sits 3.7e-3
# from the CPU's and 2.7e-3 from the JAX CLI's (the port's CPU 9.9e-4).
# Windows 0 and 1 part by 4.5e-3 (JAX) and 6.3e-3 (the port's CPU): the
# card's window 1 must lie within MPC_UC_RTOL of both window-1 bounds
# and farther than it from both window-0 bounds, or the step did not move
MPC_UC_RTOL = 5e-3


class SolveLog:
    """Within the block, every pdhg.solve call's batch size, iterations,
    windows, seconds and whether all its lanes met tol (status OPTIMAL);
    and, by shape, the first problem a solve handed the window kernel as
    a batch of one (gap_estimators' sampled EF: one_problems)."""

    def __enter__(self):
        from mpisppy_tpu_torch.ops import pdhg, pdhg_window
        self.real, self.solves, self.one_problems = pdhg.solve, [], {}

        def logged(p, opts=pdhg.PDHGOptions(), state=None):
            t0 = time.perf_counter()
            st = self.real(p, opts, state)
            S, k = int(st.status.numel()), int(st.k)
            self.solves.append(
                {"S": S, "iters": k, "windows": -(-k // opts.restart_period),
                 "s": time.perf_counter() - t0,
                 "met_tol": bool((st.status == pdhg.OPTIMAL).all())})
            if S == 1 and p.c.is_cuda and pdhg_window.supported(p):
                self.one_problems.setdefault((p.m, p.n), p)
            return st
        pdhg.solve = logged
        return self

    def __exit__(self, *exc):
        from mpisppy_tpu_torch.ops import pdhg
        pdhg.solve = self.real
        return False

    def fields(self):
        return {"windows": json.dumps([s["windows"] for s in self.solves])
                .replace(" ", ""),
                "solve_s": json.dumps([round(s["s"], 2) for s in self.solves])
                .replace(" ", ""),
                "met_tol": json.dumps([s["met_tol"] for s in self.solves])
                .replace(" ", "")}

    def held(self, group, floor=False):
        """held_window (with `floor`, by parity's f32-floor rule), in
        f32 from a random mid-solve state, of every shape the block's
        solves handed the window kernel as one problem.  Returns
        {(m, n): max_abs_err}."""
        errs = {}
        for (m, n), qp in self.one_problems.items():
            errs[m, n] = held_window(f"one_problem_{m}x{n}", qp,
                                     random_state_args(qp), modes=("f32",),
                                     group=group, floor=floor)["f32"]
        phase(group, shapes=len(errs), max_abs_err=max(errs.values(),
                                                       default=None))
        return errs


def ci_cfg(**kw):
    from mpisppy_tpu_torch.utils.config import Config
    cfg = Config()
    for k, v in kw.items():
        cfg.quick_assign(k, type(v), v)
    return cfg


def sslp_ci_cfg(num_scens):
    """The headline's sslp 15x45 LP relaxation, as kw_creator reads it."""
    return ci_cfg(num_scens=num_scens, n_servers=SSLP_SERVERS,
                  n_clients=SSLP_CLIENTS, sslp_lp_relax=True)


def launches_since_reset():
    from mpisppy_tpu_torch.ops import pdhg_window
    return dict(pdhg_window.run_window.launches_by_design)


def ci_zhat(xhat, inner):
    """[ci_zhat]: zhat4xhat.evaluate_sample_trees at the headline's
    certified incumbent root `xhat` on CI_ZHAT_SAMPLES fresh batches of
    HEADLINE_SCENS scenarios (past the headline's), f32 at CI_ZHAT_TOL
    with a CI_ZHAT_CAP-iteration cap: each evaluation's windows and
    whether it met tol, zhatbar +/- eps (the t-interval of run_samples)
    beside the headline's inner bound; every sample feasible and K1
    f32/resident launched.  Returns the launches by design."""
    import numpy as np
    import scipy.stats

    from mpisppy_tpu_torch.confidence_intervals import zhat4xhat
    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.ops import pdhg
    opts = pdhg.PDHGOptions(tol=CI_ZHAT_TOL, max_iters=CI_ZHAT_CAP)
    reset_launches()
    t0 = time.perf_counter()
    with SolveLog() as log:
        zhats, seed = zhat4xhat.evaluate_sample_trees(
            np.asarray(xhat), CI_ZHAT_SAMPLES, sslp_ci_cfg(HEADLINE_SCENS),
            sslp, InitSeed=HEADLINE_SCENS, opts=opts, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_design = launches_since_reset()
    k1 = by_design.get("pdhg_window/f32/resident", 0)
    n = len(zhats)
    zbar = float(np.mean(zhats))
    eps = float(scipy.stats.t.ppf(0.975, n - 1) * np.std(zhats, ddof=1)
                / math.sqrt(n))
    phase("ci_zhat", S=HEADLINE_SCENS, samples=n, next_seed=seed,
          xhat=json.dumps([round(float(v), 6) for v in xhat]),
          zhats=json.dumps([float(z) for z in zhats]), zhatbar=zbar,
          eps_95=eps, headline_inner=inner, **log.fields(),
          k1_launches=k1, seconds=round(secs, 2),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (np.isfinite(zhats).all() and k1 > 0
            and seed == HEADLINE_SCENS * (1 + CI_ZHAT_SAMPLES)):
        raise AssertionError("ci_zhat: a sample not feasible at x̂, no K1 "
                             "f32/resident launch, or the seed not "
                             "advanced by the samples")
    return by_design


def ci_mmw():
    """[ci_mmw]: MMWConfidenceIntervals on sslp 15x45 at MMW_XHAT (the
    root of the JAX package's sampled EF over scenarios 0-8),
    MMW_BATCHES batches of MMW_BATCH from scenario MMW_BATCH on: the
    dense sampled EF in the split design, the evaluations in resident
    K1;
    Glist and the CI within CI_RTOL of MMW_SCALE of the JAX package's
    (tools/ci_jax_reference.py).  Returns the launches by design."""
    import numpy as np

    from mpisppy_tpu_torch.confidence_intervals import ciutils, mmw_ci
    from mpisppy_tpu_torch.models import sslp
    opts = ciutils.DEFAULT_OPTS
    if (opts.tol, opts.max_iters) != (MMW_TOL, MMW_CAP):
        raise AssertionError("ci_mmw: the CI default is not the options "
                             "the JAX values were computed at")
    reset_launches()
    t0 = time.perf_counter()
    with SolveLog() as log:
        res = mmw_ci.MMWConfidenceIntervals(
            sslp, sslp_ci_cfg(MMW_BATCH), np.asarray(MMW_XHAT),
            MMW_BATCHES, MMW_BATCH, start=MMW_BATCH, verbose=False,
            device="cuda").run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_design = launches_since_reset()
    split = sum(v for k, v in by_design.items()
                if k.startswith("pdhg_window/") and k.endswith("/split"))
    diff = max([abs(a - b) for a, b in zip(res["Glist"], MMW_JAX["Glist"])]
               + [abs(res[k] - MMW_JAX[k]) for k in
                  ("Gbar", "std", "gap_inner_bound")])
    rel = diff / max(MMW_SCALE, 1.0)
    phase("ci_mmw", batch=MMW_BATCH, batches=MMW_BATCHES,
          Glist=json.dumps(res["Glist"]), Gbar=res["Gbar"],
          gap_ci=json.dumps([0.0, res["gap_inner_bound"]]),
          jax_Glist=json.dumps(MMW_JAX["Glist"]),
          jax_gap_inner=MMW_JAX["gap_inner_bound"], max_rel_diff_vs_jax=rel,
          tol=CI_RTOL, split_launches=split, **log.fields(),
          seconds=round(secs, 2),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (rel <= CI_RTOL and split > 0
            and by_design.get("pdhg_window/f32/resident", 0) > 0):
        raise AssertionError("ci_mmw: Glist or the CI off the JAX "
                             "package's, or the EF missed the split design "
                             "or the evaluations K1")
    log.held("ci_mmw_windows")
    ci_ef_route(next(iter(log.one_problems.values())))
    return by_design


def ci_ef_route(qp):
    """[ci_ef_route]: [ci_mmw]'s first sampled EF (660 x 6,345), solved
    from a cold start at the CI default's tol both ways on the card for
    CI_EF_ROUTE_WINDOWS windows (short of the 413-500 it needs in
    [ci_mmw]): as a batch of one in the window kernel, the split design
    on an H100 (the route
    gap_estimators takes where a design takes the shape) and unbatched
    on the plain iteration (its route where none does): seconds per
    window, windows, whether tol was met and the objective.  Not on the
    main path: its launches are not counted."""
    import dataclasses

    from mpisppy_tpu_torch.confidence_intervals.ciutils import DEFAULT_OPTS
    from mpisppy_tpu_torch.ops import boxqp, pdhg
    opts = dataclasses.replace(DEFAULT_OPTS, max_iters=CI_EF_ROUTE_WINDOWS
                               * DEFAULT_OPTS.restart_period)
    flat = dataclasses.replace(qp, **{k: getattr(qp, k)[0]
                                      for k in ("c", "q", "l", "u")})
    out = {}
    for route, p in (("window", qp), ("plain", flat)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = pdhg.solve(p, opts, pdhg.init_state(p, opts))
        k = int(st.k)
        secs = time.perf_counter() - t0
        obj = float(boxqp.objective(p, st.x).reshape(-1)[0])
        out[route] = (secs, obj)
        windows = -(-k // opts.restart_period)
        phase("ci_ef_route", route=route, m=qp.m, n=qp.n,
              plan=plan_line(qp, 1) if route == "window" else "plain",
              iterations=k,
              windows=windows,
              met_tol=bool((st.status == pdhg.OPTIMAL).all()),
              seconds=round(secs, 2),
              ms_per_window=round(1e3 * secs / max(windows, 1), 3),
              scaled_objective=obj)
    phase("ci_ef_route", window_over_plain=round(
        out["window"][0] / out["plain"][0], 3),
        objective_rel_diff=abs(out["window"][1] - out["plain"][1])
        / max(abs(out["plain"][1]), 1.0))


def ci_seq_run(criterion, device):
    """SeqSampling(criterion) on farmer from CI_SEQ_SCENS scenarios on
    `device`, x̂ from the sampled EF (tol CI_SEQ_TOL), its gap estimators
    at the CI default: T, nk, converged, the CI, G, s, the candidate and
    the seconds."""
    import numpy as np

    from mpisppy_tpu_torch.algos.ef import ExtensiveForm
    from mpisppy_tpu_torch.confidence_intervals.seqsampling import (
        SeqSampling,
    )
    from mpisppy_tpu_torch.models import farmer

    def xhat_gen(names, **_kw):
        ef = ExtensiveForm({"tol": CI_SEQ_TOL, "max_iters": CI_SEQ_EF_CAP},
                           names, farmer.scenario_creator,
                           {"num_scens": len(names)}, device=device)
        ef.solve_extensive_form()
        sol = ef.get_root_solution()
        return np.array([sol[f"x{i}"] for i in range(3)])
    cfg = ci_cfg(num_scens=CI_SEQ_SCENS, **CI_SEQ_KNOBS[criterion])
    t0 = time.perf_counter()
    res = SeqSampling(farmer, xhat_gen, cfg, stopping_criterion=criterion,
                      device=device).run(maxit=CI_SEQ_MAXIT)
    if device != "cpu":
        torch.cuda.synchronize()
    return {"T": res["T"], "nk": res["nk"], "converged": res["converged"],
            "CI": res["CI"], "G": res["G"], "s": res["s"],
            "xhat": [float(v) for v in res["Candidate_solution"]],
            "s_wall": time.perf_counter() - t0}


def ci_seq_card():
    """The card halves of [ci_seq], then ([ci_seq_windows]) a window of
    each sampled-EF shape they handed the kernel held against the plain
    window: (results by criterion, launches by design)."""
    total, out = {}, {}
    with SolveLog() as log:
        for crit in CI_SEQ_KNOBS:
            reset_launches()
            out[crit] = ci_seq_run(crit, "cuda")
            merge_launches(total, launches_since_reset())
    # farmer's windows from a random state reach x ~5e4, where the f32
    # rounding of both versions lies above TOLS (0.19 at 197 x 240 on the
    # card): the kernel is held no farther from the f64 window than twice
    # the plain f32 window is
    log.held("ci_seq_windows", floor=True)
    return out, total


def ci_seq_check(card):
    """[ci_seq]: each criterion's card run against its CPU half: the
    same T, nk and converged flag, the CI's upper end within CI_RTOL."""
    for crit, g in card.items():
        c = CPU_HALVES.result(f"ci_seq_{crit}")
        rel = abs(g["CI"][1] - c["CI"][1]) / max(abs(c["CI"][1]), 1.0)
        phase("ci_seq", criterion=crit, T=g["T"], nk=g["nk"],
              converged=g["converged"], ci=json.dumps(g["CI"]), G=g["G"],
              s=g["s"], xhat=json.dumps([round(v, 4) for v in g["xhat"]]),
              cpu_T=c["T"], cpu_nk=c["nk"], cpu_ci=json.dumps(c["CI"]),
              ci_rel_diff=rel, tol=CI_RTOL, card_s=round(g["s_wall"], 2),
              cpu_s=round(c["s_wall"], 2))
        if not ((g["T"], g["nk"], g["converged"])
                == (c["T"], c["nk"], c["converged"]) and rel <= CI_RTOL):
            raise AssertionError(f"ci_seq {crit}: card and CPU runs part")


def ci_mstage_run(device):
    """gap_estimators_mstage and the multistage evaluate_sample_trees on
    aircond MSTAGE_BFS through its scengen program at MSTAGE_XHAT on
    `device` (tools/ci_jax_reference.py's settings)."""
    import numpy as np

    from mpisppy_tpu_torch.confidence_intervals import ciutils, zhat4xhat
    from mpisppy_tpu_torch.models import aircond
    from mpisppy_tpu_torch.ops import pdhg
    cfg = ci_cfg(use_scengen=True, branching_factors=list(MSTAGE_BFS))
    opts = pdhg.PDHGOptions(tol=MSTAGE_TOL, max_iters=MSTAGE_CAP)
    xhat = np.asarray(MSTAGE_XHAT)
    t0 = time.perf_counter()
    est = ciutils.gap_estimators_mstage(
        xhat, aircond, MSTAGE_TREES, cfg, MSTAGE_SEED, list(MSTAGE_BFS),
        opts=opts, device=device)
    zhats, seed = zhat4xhat.evaluate_sample_trees(
        xhat, MSTAGE_TREES, cfg, aircond, InitSeed=MSTAGE_SEED,
        branching_factors=MSTAGE_BFS, opts=opts, device=device)
    return {"G": est["G"], "s": est["s"], "seed": est["seed"],
            "zhats": [float(z) for z in zhats], "zhat_seed": int(seed),
            "s_wall": time.perf_counter() - t0}


def mstage_rel(a, b):
    """The largest difference of two [ci_mstage] results, relative to
    max(|zhat|, 1) (G and s to the mean |zhat|)."""
    scale = max(float(sum(abs(z) for z in b["zhats"]) / len(b["zhats"])),
                1.0)
    rel = [abs(a[k] - b[k]) / scale for k in ("G", "s")]
    rel += [abs(x - y) / max(abs(y), 1.0)
            for x, y in zip(a["zhats"], b["zhats"])]
    return max(rel)


def ci_mstage_card():
    reset_launches()
    out = ci_mstage_run("cuda")
    return out, launches_since_reset()


def ci_mstage_check(g, by_design):
    """[ci_mstage]: the card against its CPU half and against the JAX
    package's values (MSTAGE_JAX), each to MSTAGE_RTOL; the seeds
    advanced by the trees' node counts."""
    c = CPU_HALVES.result("ci_mstage")
    rel_cpu, rel_jax = mstage_rel(g, c), mstage_rel(g, MSTAGE_JAX)
    phase("ci_mstage", bfs=json.dumps(list(MSTAGE_BFS)), trees=MSTAGE_TREES,
          G=g["G"], s=g["s"], zhats=json.dumps(g["zhats"]), seed=g["seed"],
          jax_G=MSTAGE_JAX["G"], cpu_G=c["G"], rel_diff_vs_cpu=rel_cpu,
          rel_diff_vs_jax=rel_jax, tol=MSTAGE_RTOL,
          card_s=round(g["s_wall"], 2), cpu_s=round(c["s_wall"], 2),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (rel_cpu <= MSTAGE_RTOL and rel_jax <= MSTAGE_RTOL
            and g["seed"] == g["zhat_seed"] == MSTAGE_JAX["seed"]):
        raise AssertionError("ci_mstage: card, CPU and JAX values part")


def mpc_ccopf():
    """[mpc_ccopf]: RollingDriver on ccopf_horizon(soc=True) at the
    CCOPF_BFS tree (10,000 scenarios, MPC_CCOPF_ARGS after the recipe)
    for MPC_CCOPF_STEPS windows, step 0 cold and the rest from the shifted
    plane: per step hub iterations, seconds, the flags and the resident
    SOC launches (> 0 each), and every wheel the driver spun
    ([mpc_ccopf_spin]: a warm attempt and its cold fallback are two);
    then ([mpc_ccopf_cold]) each window 1.. that did not fall back, cold,
    for the warm plane's saving; then [mpc_ccopf_small].  Returns the
    launches by design."""
    from mpisppy_tpu_torch import generic_cylinders as gc
    from mpisppy_tpu_torch.models import ccopf
    from mpisppy_tpu_torch.mpc import RollingDriver, ccopf_horizon
    hz = ccopf_horizon(soc=True, extra_args=MPC_CCOPF_ARGS)
    cfg = gc._parse_args(ccopf, hz.step_argv(0))
    later_wins = (cfg["num_scens"] == CCOPF_BFS[0] * CCOPF_BFS[1]
                  and tuple(cfg["branching_factors"]) == CCOPF_BFS)
    drv = RollingDriver(hz, device="cuda")
    spins = []
    real_spin = drv._spin

    def logged_spin(step, warm_plane):
        out = real_spin(step, warm_plane)
        spins.append((step, warm_plane is not None, out))
        phase("mpc_ccopf_spin", step=step, warm_plane=warm_plane is not None,
              iterations=out["iterations"],
              solve_s=round(out["solve_seconds"], 3), outer=out["outer"],
              inner=out["inner"], rel_gap=out["rel_gap"])
        return out
    drv._spin = logged_spin
    total, runs, soc = {}, [], []

    def step(label, run, **extra):
        reset_launches()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_design = launches_since_reset()
        merge_launches(total, by_design)
        soc.append(by_design.get("pdhg_window_soc/f32/resident", 0))
        phase(label, step=r.step, iterations=r.iterations,
              solve_s=round(r.solve_seconds, 3), wall_s=round(wall, 2),
              warm=r.warm, cold_fallback=r.cold_fallback,
              degraded=r.degraded, outer=r.outer, inner=r.inner,
              rel_gap=r.rel_gap, soc_resident_launches=soc[-1], **extra,
              by_design=json.dumps(by_design, sort_keys=True)
              .replace(" ", ""))
        return r
    t0 = time.perf_counter()
    stream = drv.stream(MPC_CCOPF_STEPS)
    for _ in range(MPC_CCOPF_STEPS):
        runs.append(step("mpc_ccopf", lambda: next(stream),
                         S=cfg["num_scens"]))
    for r in runs[1:]:
        if not r.cold_fallback:
            step("mpc_ccopf_cold", lambda: drv.run_step(r.step),
                 warm_iterations=r.iterations,
                 warm_solve_s=round(r.solve_seconds, 3))
    phase("mpc_ccopf", later_num_scens_wins=later_wins, spins=len(spins),
          warm_steps=sum(r.warm for r in runs),
          cold_fallbacks=sum(r.cold_fallback for r in runs),
          degraded_steps=sum(r.degraded for r in runs),
          seconds=round(time.perf_counter() - t0, 2))
    # a window may end degraded (no inner bound within its hub
    # iterations): the driver types it and the stream goes on.  Since the
    # recipe stops only on the gap (ROADMAP C1), the (10,10) windows
    # certify on the CPU, the warm ones in more hub iterations than cold
    # (tools/mpc_c11_probe.py); at this tree no x̂ bound landed in 201
    # hub iterations on the card (ROADMAP C13; the JAX driver not run at
    # this size)
    if not (later_wins and all(n > 0 for n in soc) and not runs[0].warm
            and all(math.isfinite(r.outer) for r in runs)):
        raise AssertionError("mpc_ccopf: --num-scens/--branching-factors "
                             "not the later values, a window without a "
                             "resident SOC launch, or no outer bound")
    merge_launches(total, mpc_ccopf_small())
    return total


def mpc_ccopf_small():
    """[mpc_ccopf_small]: the (3,3) ccopf --soc horizon on the card for
    MPC_STEPS windows against MPC_CCOPF_SMALL_JAX.  Returns the launches
    by design."""
    from mpisppy_tpu_torch.mpc import RollingDriver, ccopf_horizon
    reset_launches()
    t0 = time.perf_counter()
    runs = list(RollingDriver(ccopf_horizon(soc=True), device="cuda")
                .stream(MPC_STEPS))
    torch.cuda.synchronize()
    by_design = launches_since_reset()
    rel = max(abs(getattr(r, f) - j[f]) / max(abs(j[f]), 1.0)
              for r, j in zip(runs, MPC_CCOPF_SMALL_JAX)
              for f in ("outer", "inner"))
    flags = [r.warm for r in runs] == [j["warm"]
                                       for j in MPC_CCOPF_SMALL_JAX]
    phase("mpc_ccopf_small", steps=len(runs),
          outer=json.dumps([r.outer for r in runs]),
          inner=json.dumps([r.inner for r in runs]),
          iterations=json.dumps([r.iterations for r in runs]),
          warm=json.dumps([r.warm for r in runs]),
          max_rel_diff_vs_jax=rel, tol=MPC_RTOL, same_warm_flags=flags,
          seconds=round(time.perf_counter() - t0, 2),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (rel <= MPC_RTOL and flags):
        raise AssertionError("mpc_ccopf_small: per-step bounds or warm "
                             "flags off the JAX driver's")
    return by_design


def mpc_uc_args(step):
    """The uc horizon's recipe at tests/test_mpc.py's size (2 units, 4
    hours, 3 scenarios) for window `step`, 1 PH iteration."""
    from mpisppy_tpu_torch.mpc import uc_horizon
    return uc_horizon(2, 4, 1, max_step_iterations=1).step_argv(step)


def mpc_uc_cpu():
    """The CPU half of [mpc_uc_cli]: the CLI's JSON line at windows 0 and
    MPC_UC_STEP with --device cpu."""
    import contextlib
    import io

    from mpisppy_tpu_torch import generic_cylinders
    out = {}
    for step in (0, MPC_UC_STEP):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            generic_cylinders.main(mpc_uc_args(step) + ["--device", "cpu"])
        out[step] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return out


def mpc_uc_cli():
    """The card half of [mpc_uc_cli]: the CLI with --uc-mpc-step
    MPC_UC_STEP --uc-mpc-stride 1 (an ELL batch: no window kernel).
    Returns its JSON result."""
    return cli_run("mpc_uc_cli", mpc_uc_args(MPC_UC_STEP),
                   box_kernel=False)[0]


def mpc_uc_check(result):
    """[mpc_uc_cli]: the card's window-MPC_UC_STEP outer bound within
    MPC_UC_RTOL of its CPU half's and of the JAX CLI's, and farther than
    MPC_UC_RTOL from both packages' window-0 bounds (the step moved the
    instance); the same hub rows."""
    cpu = CPU_HALVES.result("mpc_uc_cli")
    ob = result["outer_bound"]

    def rel(ref):
        return abs(ob - ref) / abs(ref)
    near = {"cpu": rel(cpu[MPC_UC_STEP]["outer_bound"]),
            "jax": rel(MPC_UC_JAX["outer_bound"])}
    far = {"cpu_step0": rel(cpu[0]["outer_bound"]),
           "jax_step0": rel(MPC_UC_JAX["outer_bound_step0"])}
    phase("mpc_uc_cli", mpc_step=MPC_UC_STEP, outer=ob,
          cpu_outer=cpu[MPC_UC_STEP]["outer_bound"],
          cpu_outer_step0=cpu[0]["outer_bound"],
          jax_outer=MPC_UC_JAX["outer_bound"],
          jax_outer_step0=MPC_UC_JAX["outer_bound_step0"],
          rel_diff_vs_cpu=near["cpu"], rel_diff_vs_jax=near["jax"],
          rel_diff_vs_cpu_step0=far["cpu_step0"],
          rel_diff_vs_jax_step0=far["jax_step0"], tol=MPC_UC_RTOL)
    if not (max(near.values()) <= MPC_UC_RTOL < min(far.values())
            and result["iterations"] == cpu[MPC_UC_STEP]["iterations"]
            == MPC_UC_JAX["iterations"]):
        raise AssertionError("mpc_uc_cli: off the CPU half or the JAX CLI "
                             "at its window, or as near window 0's")


def ci_runs(xhat, inner):
    """The sslp confidence-interval phases (a card worker's entry beside
    the MIP group): [ci_zhat] at the headline's x̂ and [ci_mmw] (with
    [ci_mmw_windows], [ci_ef_route]).  Returns the launches by design."""
    t0 = time.perf_counter()
    total = {}
    merge_launches(total, ci_zhat(xhat, inner))
    merge_launches(total, ci_mmw())
    phase("ci_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return total


def ci_small_runs():
    """The card halves of [ci_seq] (with [ci_seq_windows]) and
    [ci_mstage].  Returns {"launches", "seq", "mstage",
    "mstage_launches"}: the CPU comparisons run where the CPU halves are
    (ci_check)."""
    total = {}
    seq, launches = ci_seq_card()
    merge_launches(total, launches)
    mstage, mstage_launches = ci_mstage_card()
    merge_launches(total, mstage_launches)
    return {"launches": total, "seq": seq, "mstage": mstage,
            "mstage_launches": mstage_launches}


def ci_check(res):
    """ci_small_runs' card halves against their CPU halves.  Returns the
    launches by design."""
    ci_seq_check(res["seq"])
    ci_mstage_check(res["mstage"], res["mstage_launches"])
    return res["launches"]


def mpc_runs():
    """The rolling-horizon phases' card halves (a card worker's entry
    beside the MIP group): [mpc_ccopf] (with [mpc_ccopf_cold],
    [mpc_ccopf_small]) and [mpc_uc_cli].  Returns {"launches",
    "uc_cli"}: the CPU comparison runs where the CPU halves are
    (mpc_check)."""
    t0 = time.perf_counter()
    total = mpc_ccopf()
    uc_cli = mpc_uc_cli()
    phase("mpc_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return {"launches": total, "uc_cli": uc_cli}


def mpc_check(res):
    """The rolling-horizon card halves against their CPU half.  Returns
    the launches by design."""
    mpc_uc_check(res["uc_cli"])
    return res["launches"]


def mpc_and_ci_small_runs():
    """The second slice-15 card worker's entry: the rolling horizon,
    then the small confidence-interval phases (farmer, aircond), so that
    neither worker outlasts the slice-9 CLI group.  Returns {"mpc",
    "ci_small"}."""
    return {"mpc": mpc_runs(), "ci_small": ci_small_runs()}


# serving (mpisppy_tpu_torch/serve/, mpc/stream.py): sessions served by an
# in-process WheelServer on a unix socket, their wheels in the server's
# worker threads on the card
SERVE_HEADLINE_ARGS = ("--n-servers", str(SSLP_SERVERS), "--n-clients",
                       str(SSLP_CLIENTS), "--xhatshuffle", "--slammin",
                       "--iter-precision", "bf16x3", "--default-rho", "20",
                       "--sslp-lp-relax")
SERVE_HEADLINE_RTOL = 1e-6     # the same code on the same argv
SERVE_MIX_RTOL = 1e-4          # the ring reorders host exchanges only
SERVE_MIX_MAX_ITERS = 300      # bench.py's bench_serve_load smoke shape
SERVE_MIX_DEADLINE_S = 600.0
SERVE_COALESCE_SCENS = 1_000   # [bnb_operands]' node LPs, per session
SERVE_STREAM_STEPS = 4
SERVE_STREAM_ARGS = ("--uc-n-gens", "3", "--uc-n-hours", "6")
SERVE_STREAM_GAP = 0.05
# a window's hub iterations (SubmitRequest's default 200 cut to 100: a
# warm window that misses the gap falls back cold, so a window costs at
# most two wheels of this many)
SERVE_STREAM_MAX_ITERS = 100
SERVE_STREAM_RTOL = 1e-6
SERVE_STREAM_PREEMPT_STEP = 2


def serve_options(td, device, **kw):
    import os

    from mpisppy_tpu_torch.serve import ServeOptions
    return ServeOptions(unix_path=os.path.join(td, "wheel.sock"),
                        trace_dir=os.path.join(td, "traces"),
                        spool_dir=os.path.join(td, "spool"),
                        device=str(device), **kw)


def served(address, spec, on_line=None, timeout=1800.0):
    """Submit `spec` through a ServeClient and read the session's lines to
    its terminal one: (the ack, the session's lines, client seconds)."""
    from mpisppy_tpu_torch.serve import loadgen
    from mpisppy_tpu_torch.serve.protocol import TERMINAL_EVENTS
    cl = loadgen.ServeClient(address, timeout=timeout)
    try:
        t0 = time.perf_counter()
        ack = cl.submit(spec)
        lines = []
        if ack.get("ok"):
            for msg in cl.stream():
                if msg.get("session") not in (None, ack["session"]):
                    continue
                lines.append(msg)
                if on_line is not None:
                    on_line(msg)
                if msg.get("event") in TERMINAL_EVENTS:
                    break
        return ack, lines, time.perf_counter() - t0
    finally:
        cl.close()


def events_of(lines, kind):
    return [m for m in lines if m.get("event") == kind]


def max_rel(pairs):
    return max(abs(a - b) / max(abs(b), 1.0) for a, b in pairs)


#: [serve_headline]'s progress lines, done line and K2 launches, the
#: reference [fleet_migrate] holds its migrated session to
SERVED_HEADLINE = {}


def serve_headline(cli_headline, device="cuda", S=HEADLINE_SCENS):
    """[serve_headline]: the CLI headline (sslp 15x45, S scenarios, bf16x3,
    rho 20, all four fusable spokes, CLI_HEADLINE_ITERS hub iterations)
    as one session of WheelServer(multiplex=False): accepted, a progress
    line per hub row, done, its bounds [cli_headline]'s for the same
    argv within SERVE_HEADLINE_RTOL, its windows in K2.  Returns the
    launches by design."""
    import tempfile

    from mpisppy_tpu_torch.serve import SubmitRequest, WheelServer
    spec = SubmitRequest(tenant="headline", sla="throughput", model="sslp",
                         num_scens=S, gap_target=0.01,
                         max_iterations=CLI_HEADLINE_ITERS,
                         args=SERVE_HEADLINE_ARGS)
    with tempfile.TemporaryDirectory(prefix="serve") as td:
        srv = WheelServer(serve_options(td, device, multiplex=False,
                                        max_running=1)).start()
        try:
            reset_launches()
            ack, lines, secs = served(srv.address, spec)
            by_design = launches_since_reset()
        finally:
            srv.stop()
    done = events_of(lines, "done")
    progress = events_of(lines, "progress")
    # a capped run may end before its inner bound lands (null in both)
    pairs = [(done[0][f], cli_headline[f + "_bound"])
             for f in ("outer", "inner")
             if done and cli_headline[f + "_bound"] is not None]
    rel = max_rel(pairs) if done and cli_headline["outer_bound"] is not \
        None and (done[0]["inner"] is None) == (
            cli_headline["inner_bound"] is None) else math.inf
    k2 = by_design.get("pdhg_window/bf16x3/resident", 0)
    phase("serve_headline", S=S, accepted=bool(ack.get("ok")),
          progress_lines=len(progress),
          terminal=",".join(m["event"] for m in lines
                            if m.get("event") in ("done", "failed",
                                                  "rejected")),
          hub_iters=done[0]["iterations"] if done else None,
          outer=done[0]["outer"] if done else None,
          inner=done[0]["inner"] if done else None,
          cli_outer=cli_headline["outer_bound"],
          cli_inner=cli_headline["inner_bound"], max_rel_diff_vs_cli=rel,
          tol=SERVE_HEADLINE_RTOL, client_s=round(secs, 3),
          solve_s=done[0]["solve_seconds"] if done else None,
          k2_launches=k2,
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    SERVED_HEADLINE.update(progress=progress, done=done[0] if done else None,
                           k2=k2)
    on_card = torch.device(device).type == "cuda"
    if not (ack.get("ok") and len(done) == 1 and lines[-1] is done[0]
            and len(progress) >= done[0]["iterations"]
            and done[0]["iterations"] == cli_headline["iterations"]
            and rel <= SERVE_HEADLINE_RTOL and (k2 > 0 or not on_card)):
        raise AssertionError("serve_headline: not accepted, no single done "
                             "line, a hub row unstreamed, bounds off "
                             "[cli_headline], or no K2 launch")
    return by_design


def serve_mix(device="cuda"):
    """[serve_mix]: WheelServer(multiplex=True, max_running=3,
    tenant_quota=1) under loadgen.run_load (4 clients, tenants acme and
    zeta, one session each of DEFAULT_MIX, gap 1%, SERVE_MIX_MAX_ITERS):
    every session ends in exactly one terminal outcome, done, and each
    one's bounds equal the same spec solved alone through
    WheelEngine(multiplexed=True) within SERVE_MIX_RTOL.  Prints p50/p99
    time to gap, the ring's grants and waits, the interner's hits, the
    scheduler's stats and the launches by design.  Returns the served
    run's launches by design."""
    import tempfile

    from mpisppy_tpu_torch.serve import WheelServer, loadgen
    from mpisppy_tpu_torch.serve.engine import WheelEngine
    from mpisppy_tpu_torch.serve.session import Session
    with tempfile.TemporaryDirectory(prefix="serve") as td:
        srv = WheelServer(serve_options(
            td, device, multiplex=True, max_running=3, tenant_quota=1,
            max_queued=24, max_queued_per_tenant=8)).start()
        try:
            reset_launches()
            t0 = time.perf_counter()
            recs = loadgen.run_load(
                srv.address, n_clients=4, sessions_each=1,
                tenants=("acme", "zeta"), mix=loadgen.DEFAULT_MIX,
                gap_target=0.01, max_iterations=SERVE_MIX_MAX_ITERS,
                deadline_s=SERVE_MIX_DEADLINE_S)
            wall = time.perf_counter() - t0
            by_design = launches_since_reset()
            stats = srv.stats()
            sessions = list(srv._sessions.values())
            interner = srv.engine.interner.stats()
        finally:
            srv.stop()
    summ = loadgen.summarize(recs)
    phase("serve_mix", sessions=len(sessions),
          outcomes=json.dumps(summ["outcomes"], sort_keys=True)
          .replace(" ", ""),
          time_to_gap_p50_s=summ["time_to_gap_p50_s"],
          time_to_gap_p99_s=summ["time_to_gap_p99_s"],
          total_p50_s=summ["total_p50_s"], wall_s=round(wall, 2),
          ring=json.dumps(stats.get("exchange_ring")).replace(" ", ""),
          interner=json.dumps(interner, sort_keys=True).replace(" ", ""),
          dispatch=json.dumps({k: v for k, v in (stats.get("dispatch") or {})
                               .items() if k != "by_key"})
          .replace(" ", ""),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    ok = len(sessions) == len(recs) == 4 and all(
        r["outcome"] == "done" for r in recs) and all(
        s.state == "DONE" and s.outcome["event"] == "done"
        for s in sessions)
    worst = 0.0
    for s in sessions:
        if s.outcome is None or s.outcome["event"] != "done":
            continue
        t0 = time.perf_counter()
        _, solo = WheelEngine(multiplexed=True, device=device).run(
            Session(s.spec))
        rel = max_rel(((s.outcome[f], solo[f]) for f in ("outer", "inner")))
        worst = max(worst, rel)
        phase("serve_mix_session", tenant=s.tenant, sla=s.sla,
              model=s.spec.model, num_scens=s.spec.num_scens,
              hub_iters=s.outcome["iterations"], outer=s.outcome["outer"],
              inner=s.outcome["inner"], rel_gap=s.outcome["rel_gap"],
              served_solve_s=s.outcome["solve_seconds"],
              total_s=round(s.seconds(), 3),
              solo_outer=solo["outer"], solo_inner=solo["inner"],
              solo_hub_iters=solo["iterations"],
              solo_s=round(time.perf_counter() - t0, 3),
              max_rel_diff_vs_solo=rel, tol=SERVE_MIX_RTOL)
    if not (ok and worst <= SERVE_MIX_RTOL
            and stats["exchange_ring"]["grants"] > 0):
        raise AssertionError("serve_mix: a session without exactly one "
                             "done outcome, bounds off its solo run, or no "
                             "exchange through the ring")
    return by_design


def node_lp_solve(qp, d_col, int_cols, opts, **kw):
    """The scheduler's solve for [serve_coalesce]: the node LPs'
    relaxation by the restarted PDHG from a cold start, ||A|| estimated
    once from the shared A (so a lane's iterates do not depend on the
    batch it rides in), the LP value as both bounds."""
    import dataclasses

    from mpisppy_tpu_torch.ops import bnb, pdhg
    lp = mip_node_lp()
    one = dataclasses.replace(qp, c=qp.c.reshape(-1, qp.n)[0])
    st = pdhg.init_state(qp, lp, Lnorm=pdhg.estimate_norm(one,
                                                         lp.power_iters))
    st = pdhg.solve(qp, lp, state=st)
    obj = (qp.c * st.x + 0.5 * qp.q * st.x * st.x).sum(-1)
    S = st.x.shape[0]
    return bnb.BnBResult(x=st.x, inner=obj, outer=obj,
                         gap=torch.zeros_like(obj), feasible=st.done,
                         nodes_solved=torch.ones(S, dtype=torch.int32,
                                                 device=obj.device))


def serve_coalesce(device="cuda", S=SERVE_COALESCE_SCENS):
    """[serve_coalesce]: two sessions' sslp 15x45 node LPs (S lanes each,
    node_boxes shifted by 13 lanes for the second; each session builds
    its own batch) interned through one
    StructureInterner and submitted concurrently from two threads, each
    with its session token, to one coalescing SolveScheduler: one
    dispatch of 2S lanes in resident K1 f32, every lane equal to its
    solo solve within TOLS f32, the breakdown naming both runs; the
    same submits uninterned make two dispatches.  Returns the coalesced
    dispatch's launches by design."""
    import threading

    from mpisppy_tpu_torch import dispatch
    from mpisppy_tpu_torch.ops import bnb
    from mpisppy_tpu_torch.serve import multiplex
    interner = multiplex.StructureInterner()
    raw, interned = [], []
    for i in range(2):
        batch, _ = sslp_mip_batch(S, SSLP_SERVERS, SSLP_CLIENTS, device)
        cols, lo, hi = node_boxes(batch, shift=13 * i)
        node = bnb._node_qp(batch.qp, batch.d_col, cols, lo, hi)
        ic = cols.cpu().numpy()
        raw.append((node, batch.d_col, ic))
        qp, d = multiplex.intern_qp(node, batch.d_col, interner=interner)
        interned.append((qp, d, ic))
    same_A = interned[0][0].A is interned[1][0].A

    def concurrent(sched, reqs):
        out, barrier = {}, threading.Barrier(len(reqs))

        def worker(i):
            # both submit before either blocks: result() dispatches its
            # window at once
            dispatch.set_session_context(f"serve-coalesce-{i}", 0)
            try:
                ticket = sched.submit(*reqs[i])
                barrier.wait(timeout=60)
                out[i] = ticket.result(timeout=600)
            finally:
                dispatch.clear_session_context()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        stats = sched.stats()
        sched.close()
        return out, stats

    from mpisppy_tpu_torch import telemetry as tel
    probe = EventProbe(tel.DISPATCH)
    bus = tel.EventBus()
    bus.subscribe(probe)
    reset_launches()
    t0 = time.perf_counter()
    res, st = concurrent(dispatch.SolveScheduler(
        dispatch.DispatchOptions(coalesce=True, max_wait_ms=5000.0),
        solve_fn=node_lp_solve, bus=bus, run="serve-coalesce"), interned)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_design = launches_since_reset()
    errs, within = [], True
    for i, (qp, d, ic) in enumerate(interned):
        solo = node_lp_solve(qp, d, ic, None)
        err, ok = max_err([res[i].x, res[i].inner], [solo.x, solo.inner],
                          "f32")
        errs.append(err)
        within = within and ok
    _, control = concurrent(dispatch.SolveScheduler(
        dispatch.DispatchOptions(coalesce=True, max_wait_ms=5000.0),
        solve_fn=node_lp_solve), raw)
    runs = sorted(s["run"] for d in probe.of(tel.DISPATCH)
                  for s in d.get("sessions", ()))
    phase("serve_coalesce", S_per_session=S, same_A_object=same_A,
          interner=json.dumps(interner.stats(), sort_keys=True)
          .replace(" ", ""),
          batches=st["batches"], lanes=st["lanes"],
          pad_lanes=st["pad_lanes"], coalesced_lanes=st["coalesced_lanes"],
          runs=",".join(runs), seconds=round(secs, 3),
          max_abs_err_vs_solo=max(errs), within_tol=within,
          tol=json.dumps(TOLS["f32"]),
          uninterned_batches=control["batches"],
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    on_card = torch.device(device).type == "cuda"
    if not (same_A and st["batches"] == 1 and st["lanes"] == 2 * S
            and st["coalesced_lanes"] == 2 * S
            and runs == ["serve-coalesce-0", "serve-coalesce-1"]
            and (set(by_design) == {"pdhg_window/f32/resident"}
                 or not on_card)
            and within and control["batches"] == 2):
        raise AssertionError("serve_coalesce: not one coalesced K1 dispatch "
                             "of both sessions' lanes, a lane off its solo "
                             "solve, or the uninterned control coalesced")
    return by_design


def serve_stream(device="cuda", steps=SERVE_STREAM_STEPS,
                 args=SERVE_STREAM_ARGS):
    """[serve_stream]: a uc MPC stream (`steps` windows, gap
    SERVE_STREAM_GAP) through WheelServer: a step line per window, then
    done, each step's bounds those of RollingDriver(horizon_for(spec))
    run directly within SERVE_STREAM_RTOL; then the same stream preempted
    entering step SERVE_STREAM_PREEMPT_STEP (the hub's preempt_event,
    set when the client reads the step before and cleared when it reads
    the preempted line) resumes from its spool checkpoint with the
    fault-free stream's step lines bit for bit.
    Returns the launches by design (uc's ELL batch: none expected)."""
    import tempfile

    from mpisppy_tpu_torch.mpc import RollingDriver, horizon_for
    from mpisppy_tpu_torch.serve import SubmitRequest, WheelServer
    spec = SubmitRequest(tenant="grid", sla="latency", model="uc",
                         num_scens=3, gap_target=SERVE_STREAM_GAP,
                         max_iterations=SERVE_STREAM_MAX_ITERS, args=args,
                         mpc_steps=steps, step_deadline_s=1200.0)
    with tempfile.TemporaryDirectory(prefix="serve") as td:
        srv = WheelServer(serve_options(td, device, multiplex=False,
                                        max_running=1)).start()
        try:
            reset_launches()
            ack, lines, secs = served(srv.address, spec)

            def preempt(msg):
                # the drain signal stays set until its owner clears it;
                # the resumed window reaches its first sync only after
                # its cold iter0 windows, long after this line is read
                ev = srv._sessions[msg["session"]].preempt_event
                if msg.get("event") == "step" \
                        and msg["step"] == SERVE_STREAM_PREEMPT_STEP - 1:
                    ev.set()
                elif msg.get("event") == "preempted":
                    ev.clear()
            ack2, lines2, secs2 = served(srv.address, spec, on_line=preempt)
            by_design = launches_since_reset()
            stats = srv.stats()
        finally:
            srv.stop()
    t0 = time.perf_counter()
    direct = list(RollingDriver(horizon_for(spec), device=device)
                  .stream(steps))
    direct_s = time.perf_counter() - t0
    base = {m["step"]: m for m in events_of(lines, "step")}
    chaos = {m["step"]: m for m in events_of(lines2, "step")}
    pairs = [(base[r.step][f], getattr(r, f)) for r in direct
             if r.step in base for f in ("outer", "inner")
             if math.isfinite(getattr(r, f))]
    rel = max_rel(pairs) if pairs else math.inf
    same = sorted(chaos) == sorted(base) and all(
        chaos[k][f] == base[k][f] for k in base
        for f in ("outer", "inner", "rel_gap", "x_root", "warm"))
    done, done2 = events_of(lines, "done"), events_of(lines2, "done")
    phase("serve_stream", steps=len(base), client_s=round(secs, 3),
          outer=json.dumps([base[k]["outer"] for k in sorted(base)]),
          inner=json.dumps([base[k]["inner"] for k in sorted(base)]),
          warm=json.dumps([base[k]["warm"] for k in sorted(base)]),
          step_latency_s=json.dumps([base[k]["latency_s"]
                                     for k in sorted(base)]),
          degraded_steps=done[0]["degraded_steps"] if done else None,
          direct_s=round(direct_s, 3), max_rel_diff_vs_driver=rel,
          tol=SERVE_STREAM_RTOL,
          preempted_lines=len(events_of(lines2, "preempted")),
          resumed_client_s=round(secs2, 3), resumed_equal_bit_for_bit=same,
          preemptions=stats["preemptions"],
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (ack.get("ok") and ack2.get("ok") and len(done) == 1
            and len(done2) == 1 and sorted(base) == list(range(steps))
            and len(pairs) >= steps and rel <= SERVE_STREAM_RTOL
            and len(events_of(lines2, "preempted")) == 1
            and done2[0]["preemptions"] == 1 and same):
        raise AssertionError("serve_stream: a step line missing, bounds off "
                             "the RollingDriver's, or the resumed stream "
                             "not bit-identical to the fault-free one")
    return by_design


def serve_runs(cli_headline):
    """The serving phases (a card worker's entry beside the other
    groups): returns the launches by design of the served runs."""
    t0 = time.perf_counter()
    total = {}
    merge_launches(total, serve_headline(cli_headline))
    torch.cuda.empty_cache()
    merge_launches(total, fleet_migrate(SERVED_HEADLINE))
    torch.cuda.empty_cache()
    merge_launches(total, serve_mix())
    merge_launches(total, serve_coalesce())
    torch.cuda.empty_cache()
    merge_launches(total, serve_stream())
    phase("serve_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return total


# the fleet and the scenario mesh (mpisppy_tpu_torch/fleet/, parallel/)
FLEET_KILL_AFTER = 2          # the hub iteration after which the kill lands
MESH_NCCL_ITERS = 10          # [mesh_nccl]'s rows, held to [headline]'s
MESH_PROFILE_ITER = 5         # the profiled hub iteration
MESH_SLOTS = 8                # the elastic layout: 8 device slots ...
MESH_HOSTS = 4                # ... over 4 hosts (2 slots each)
MESH_STRAGGLE_AT = 3          # the straggling harvest's hub iteration
MESH_DEADLINE_S = 5.0         # the harvest deadline it misses ...
MESH_STRAGGLE_S = 7.0         # ... by this delay
MESH_BRACKET_RTOL = 1e-3      # [mesh_elastic]'s bounds against [headline]'s
MESH_HYDRO_RTOL = 1e-6        # node averages: atomic add order (index_add_)


def kill_after(at, sessions):
    """A FaultPlan whose ReplicaFault("kill") hits the replica running a
    session once that session's hub reaches the sync of hub iteration
    `at`; that sync then waits for the drain to set the session's
    preempt_event, so the next sync checkpoints — the migration lands at
    one hub iteration on every run.  `sessions()` lists the router's
    sessions."""
    import threading

    from mpisppy_tpu_torch.resilience.faults import FaultPlan, ReplicaFault

    class KillAfter(FaultPlan):
        def __init__(self):
            super().__init__(replicas=(ReplicaFault("kill"),))
            self.target = None
            self.gate = threading.Event()

        def replica_kill(self, rid, beat):
            return self.gate.is_set() and rid == self.target \
                and super().replica_kill(rid, beat)

        def maybe_preempt(self, hub_iter):
            super().maybe_preempt(hub_iter)
            if hub_iter != at or self.gate.is_set():
                return
            running = [s for s in sessions() if s.state == "RUNNING"]
            self.target = running[0].replica if running else None
            self.gate.set()
            deadline = time.perf_counter() + 120.0
            while time.perf_counter() < deadline and not any(
                    s.preempt_event.is_set() for s in running):
                time.sleep(0.01)

    return KillAfter()


def fleet_migrate(ref, device="cuda", S=HEADLINE_SCENS):
    """[fleet_migrate]: [serve_headline]'s spec through a FleetRouter of
    two replicas on the card (multiplex off, one slot each); the
    replica running it is killed (ReplicaFault "kill") after hub
    iteration FLEET_KILL_AFTER, the session checkpoints into the shared
    spool at the next sync and finishes on the other replica.  Its rows
    after the resume and its done line must equal [serve_headline]'s
    bit for bit, fleet_migrations_lost_total must stay 0.  Prints the
    migration gap (the preempted line to the destination's first
    progress line, client clock), the snapshot's bytes and the K2
    launches against [serve_headline]'s.  Returns the launches by
    design."""
    import os
    import tempfile

    from mpisppy_tpu_torch.fleet import FleetOptions, FleetRouter
    from mpisppy_tpu_torch.serve import SubmitRequest
    from mpisppy_tpu_torch.telemetry import metrics as _metrics
    spec = SubmitRequest(tenant="headline", sla="throughput", model="sslp",
                         num_scens=S, gap_target=0.01,
                         max_iterations=CLI_HEADLINE_ITERS,
                         args=SERVE_HEADLINE_ARGS)
    stamps = []

    def on_line(msg):
        stamps.append((time.perf_counter(), msg))

    lost0 = _metrics.REGISTRY.get("fleet_migrations_lost_total")
    router = None
    plan = kill_after(FLEET_KILL_AFTER,
                      lambda: list(router._sessions.values()))
    with tempfile.TemporaryDirectory(prefix="fleet") as td:
        router = FleetRouter(FleetOptions(
            unix_path=os.path.join(td, "fleet.sock"), n_replicas=2,
            max_running_per_replica=1, multiplex=False,
            trace_dir=os.path.join(td, "traces"),
            spool_dir=os.path.join(td, "spool"), heartbeat_s=0.1,
            drain_grace_s=120.0, fault_plan=plan,
            device=str(device))).start()
        try:
            reset_launches()
            ack, lines, secs = served(router.address, spec, on_line)
            by_design = launches_since_reset()
            stats = router.stats()
        finally:
            router.stop()
        sid = ack.get("session")
        writes = []
        for rid in ("r0", "r1"):
            p = os.path.join(td, "traces", rid, f"session-{sid}.jsonl")
            if os.path.exists(p):
                with open(p) as f:
                    writes += [json.loads(ln)["data"] for ln in f
                               if '"checkpoint-write"' in ln]
    lost = _metrics.REGISTRY.get("fleet_migrations_lost_total") - lost0
    done = events_of(lines, "done")
    pre = [(t, m) for t, m in stamps if m.get("event") == "preempted"]
    after = [(t, m) for t, m in stamps if pre and t > pre[0][0]
             and m.get("event") == "progress"]
    gap_s = after[0][0] - pre[0][0] if pre and after else None
    resumed = [m for _, m in after]
    want = {m["iter"]: m for m in ref["progress"]}
    keys = ("iter", "outer", "inner", "rel_gap")
    same_rows = bool(resumed) and all(
        m["iter"] in want and all(m[k] == want[m["iter"]][k] for k in keys)
        for m in resumed)
    same_done = bool(done) and ref["done"] is not None and all(
        done[0][k] == ref["done"][k]
        for k in ("outer", "inner", "rel_gap", "iterations"))
    k2 = by_design.get("pdhg_window/bf16x3/resident", 0)
    mig = stats["migration"]
    phase("fleet_migrate", S=S, replicas=2, killed=plan.target,
          preempted_at=pre[0][1].get("iter") if pre else None,
          resumed_iters=json.dumps([m["iter"] for m in resumed]),
          rows_equal_serve_headline=same_rows,
          done_equal_serve_headline=same_done,
          outer=done[0]["outer"] if done else None,
          inner=done[0]["inner"] if done else None,
          migration_gap_s=None if gap_s is None else round(gap_s, 3),
          snapshot_bytes=writes[-1]["bytes"] if writes else None,
          migrations=json.dumps(mig).replace(" ", ""),
          fleet_migrations_lost_total=lost,
          health=json.dumps(stats["health"]).replace(" ", ""),
          k2_launches=k2, serve_headline_k2=ref["k2"],
          client_s=round(secs, 3),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (ack.get("ok") and len(done) == 1 and pre and resumed
            and mig["started"] == 1 and mig["completed"] == 1
            and mig["lost"] == 0 and lost == 0 and same_rows
            and same_done and k2 > 0):
        raise AssertionError("fleet_migrate: no single migration, a loss, "
                             "or rows after the resume off "
                             "[serve_headline]'s")
    return by_design


class NcclProfile:
    """PH extension: torch.profiler (host and device) over hub iteration
    `at`; `out` gets the collectives the mesh issued during it, the host
    ranges the NCCL process group recorded for them, and the NCCL
    kernels' count and device ms (none in a group of one rank: an
    in-place all-reduce over one rank launches nothing)."""

    def __init__(self, opt, at, out):
        self.opt, self.at, self.out = opt, at, out
        self.prof = None

    def miditer(self):
        from torch.profiler import ProfilerActivity, profile
        if self.opt._iter == self.at:
            torch.cuda.synchronize()
            self.before = dict(self.opt.batch.mesh.calls)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()

    def enditer_after_sync(self):
        if self.prof is None or self.opt._iter != self.at:
            return
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        events = recorded_events(self.prof)
        nccl = [(a, b) for name, on_dev, a, b in events
                if on_dev and "nccl" in name.lower()]
        host = [(a, b) for name, on_dev, a, b in events
                if not on_dev and "nccl" in name.lower()]
        busy = busy_us(device_spans(self.prof))
        self.out.update(
            nccl_host_ranges=len(host),
            nccl_host_ms=round(sum(b - a for a, b in host) / 1e3, 4),
            nccl_kernels=len(nccl),
            nccl_device_ms=round(sum(b - a for a, b in nccl) / 1e3, 4),
            device_busy_ms=round(busy / 1e3, 3),
            wall_ms=round(1e3 * wall, 3),
            collectives=json.dumps({
                k: self.opt.batch.mesh.calls[k] - self.before[k]
                for k in self.before}).replace(" ", ""))
        self.prof = None


def mesh_nccl(batch, ref):
    """[mesh_nccl]: the headline batch sharded over the NCCL group of one
    rank (shard_batch, pad=True), its fused wheel ([headline]'s options)
    for MESH_NCCL_ITERS hub iterations: rows equal to [headline]'s first
    ones bit for bit (every collective over one rank is the identity);
    hub iteration MESH_PROFILE_ITER profiled for its NCCL kernels.
    Returns the launches by design."""
    import functools

    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    mesh = mesh_mod.make_mesh()
    sb = mesh_mod.shard_batch(batch, mesh, pad=True)
    opts = sslp_options("bf16x3", MESH_NCCL_ITERS, 1e-6, 8)
    hub, spokes = wheel_dicts(sb, opts)
    prof = {}
    hub["opt_kwargs"]["extensions"] = functools.partial(
        NcclProfile, at=MESH_PROFILE_ITER, out=prof)
    reset_launches()
    t0 = time.perf_counter()
    ws = WheelSpinner(hub, spokes).spin()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_design = launches_since_reset()
    rows = trace_rows(ws)
    keys = ("iter", "conv", "outer", "inner")
    want = {r["iter"]: r for r in ref["rows"]}
    differ = next((r["iter"] for r in rows if r["iter"] not in want
                   or any(r[k] != want[r["iter"]][k] for k in keys)), None)
    calls = dict(mesh.calls)
    import torch.distributed as dist
    iters = ws.opt._iter
    phase("mesh_nccl", S=sb.num_scenarios, world=mesh.world,
          backend=dist.get_backend(mesh.group), ph_iters=iters,
          rows=len(rows),
          first_differing_row=differ, rows_equal_headline=differ is None,
          seconds=round(secs, 2),
          collectives=json.dumps(calls).replace(" ", ""),
          all_reduce_per_hub_iter=round(calls["all_reduce"]
                                        / max(1, iters), 2),
          **{f"profiled_iter{MESH_PROFILE_ITER}_{k}": v
             for k, v in prof.items()},
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (differ is None and iters == MESH_NCCL_ITERS
            and dist.get_backend(mesh.group) == "nccl"
            and calls["all_reduce"] > 0
            and by_design.get("pdhg_window/bf16x3/resident", 0) > 0):
        raise AssertionError("mesh_nccl: rows off [headline]'s, not NCCL, "
                             "no all-reduce or no K2 launch")
    return by_design


def mesh_hydro(dev):
    """[mesh_hydro]: one PH step (iter0 + iterk) of hydro (3,3) sharded
    over the NCCL group against the unsharded step: the multistage node
    averages (index_add_ over the global node count, then the
    all-reduce) within MESH_HYDRO_RTOL of the node values' scale (atomic
    add order on the card).  Returns the launches by design."""
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import hydro
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    b = batch_mod.from_specs(
        [hydro.scenario_creator(nm) for nm in hydro.scenario_names_creator(9)],
        tree=hydro.make_tree((3, 3)), device=dev)
    opts = ph_mod.PHOptions(default_rho=1.0, subproblem_windows=8,
                            iter0_windows=100)
    rho = torch.ones(b.num_nonants, device=dev)
    reset_launches()

    def step(batch):
        st, _, _ = ph_mod.ph_iter0(batch, rho, opts)
        return ph_mod.ph_iterk(batch, st, opts).xbar_nodes

    whole = step(b)
    split = step(mesh_mod.shard_batch(b, mesh_mod.make_mesh(), pad=True))
    by_design = launches_since_reset()
    err = float((split - whole).abs().max())
    scale = float(whole.abs().max())
    phase("mesh_hydro", S=b.num_scenarios, tree_nodes=b.tree.num_nodes,
          max_abs_diff=err, scale=scale, tol=MESH_HYDRO_RTOL,
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not err <= MESH_HYDRO_RTOL * max(1.0, scale):
        raise AssertionError("mesh_hydro: sharded node averages off the "
                             "unsharded step's")
    return by_design


def mesh_elastic(batch, ref):
    """[mesh_elastic]: the headline batch under run_elastic on a mesh of
    MESH_SLOTS device slots over MESH_HOSTS hosts (the NCCL group of one
    rank underneath), its harvest deadline MESH_DEADLINE_S: a straggler
    (MeshFault) delays hub iteration MESH_STRAGGLE_AT's harvest past it,
    MeshDegraded trips and the emergency checkpoint lands; the
    straggling host is fenced (a host whose collective missed its
    deadline leaves the mesh), run_elastic re-shards once onto the
    survivors' 6 slots (the scenario axis re-padded 10,000 -> 10,002
    through adapt_checkpoint_arrays) and runs to 1%.  Prints the
    re-shard gap (the re-shard event to the resumed run's first hub
    iteration), the iterations to 1% against [headline]'s, and the
    bracket against [headline]'s (held at MESH_BRACKET_RTOL).  Returns
    the launches by design."""
    import os
    import tempfile

    from mpisppy_tpu_torch import telemetry as tel
    from mpisppy_tpu_torch.parallel import elastic
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    from mpisppy_tpu_torch.resilience.faults import FaultPlan, MeshFault
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner

    class FenceStraggler(elastic.MeshMembership):
        """Membership that fences the last host once a harvest missed
        its deadline."""
        tripped = False

        def dead_hosts(self):
            if self.tripped and self.state(MESH_HOSTS - 1) != elastic.DEAD:
                self.force(MESH_HOSTS - 1, elastic.DEAD,
                           "straggler-fenced")
            return super().dead_hosts()

    stamps = {}

    class Probe:
        def handle(self, e):
            now = time.perf_counter()
            if e.kind == tel.MESH_STRAGGLER and e.data["mode"] == "deadline":
                mm.tripped = True
                stamps.setdefault("straggler", now)
            elif e.kind == tel.MESH_RESHARD:
                stamps.setdefault("reshard", now)
            elif e.kind == tel.HUB_ITERATION and "reshard" in stamps:
                stamps.setdefault("resumed", now)
            elif e.kind == tel.CHECKPOINT_WRITE and "straggler" in stamps:
                stamps.setdefault("bytes", e.data["bytes"])

        def close(self):
            pass

    bus = tel.EventBus()
    bus.subscribe(Probe())
    mm = FenceStraggler(MESH_HOSTS, bus=bus, run="mesh_elastic")
    opts = sslp_options("bf16x3", HEADLINE_MAX_ITERS, 1e-6, 8)
    plan = FaultPlan(meshes=(MeshFault("straggler",
                                       at_iters=(MESH_STRAGGLE_AT,),
                                       delay_s=MESH_STRAGGLE_S),))
    with tempfile.TemporaryDirectory(prefix="mesh") as td:
        ckpt = os.path.join(td, "mesh.npz")

        def build(mesh):
            sb = mesh_mod.shard_batch(batch, mesh, pad=True)
            return WheelSpinner(*wheel_dicts(sb, opts, hub_extra={
                "checkpoint_path": ckpt, "checkpoint_every_s": 1e9,
                "telemetry_bus": bus}))

        reset_launches()
        t0 = time.perf_counter()
        ws, info = elastic.run_elastic(
            build, num_hosts=MESH_HOSTS, checkpoint_path=ckpt, plan=plan,
            bus=bus, run_id="mesh_elastic",
            harvest_deadline_s=MESH_DEADLINE_S, membership=mm,
            devices=list(range(MESH_SLOTS)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        by_design = launches_since_reset()
    outer, inner = ws.BestOuterBound, ws.BestInnerBound
    rel_gap = ws.spcomm.compute_gaps()[1]
    ro, ri = ref["bounds"]
    rel = max(abs(outer - ro) / abs(ro), abs(inner - ri) / abs(ri))
    r = info["reshards"][0] if info["reshards"] else {}
    gap = stamps["resumed"] - stamps["reshard"] \
        if "resumed" in stamps and "reshard" in stamps else None
    phase("mesh_elastic", slots=MESH_SLOTS, hosts=MESH_HOSTS,
          reshards=len(info["reshards"]), reason=r.get("reason"),
          hub_iter=r.get("hub_iter"), old_devices=r.get("old_devices"),
          new_devices=r.get("new_devices"),
          scenarios=ws.spcomm.opt.batch.num_scenarios,
          snapshot_bytes=stamps.get("bytes"),
          reshard_gap_s=None if gap is None else round(gap, 3),
          iterations=ws.spcomm._iter, headline_iterations=ref["iterations"],
          outer=outer, inner=inner, rel_gap=rel_gap,
          headline_outer=ro, headline_inner=ri,
          max_rel_diff_vs_headline=rel, tol=MESH_BRACKET_RTOL,
          seconds=round(secs, 2),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    if not (len(info["reshards"]) == 1
            and r.get("reason") == "straggler-deadline"
            and (r.get("old_devices"), r.get("new_devices"))
            == (MESH_SLOTS, MESH_SLOTS - MESH_SLOTS // MESH_HOSTS)
            and ws.spcomm.opt.batch.num_scenarios != batch.num_scenarios
            and rel_gap <= 0.01 and rel <= MESH_BRACKET_RTOL):
        raise AssertionError("mesh_elastic: not one re-shard onto the "
                             "survivors, no 1% certificate, or a bracket "
                             "off [headline]'s")
    return by_design


def mesh_runs(ref):
    """The mesh phases in an NCCL process group of one rank (this card;
    NCCL takes one rank per card, so a larger world needs more cards):
    [mesh_nccl], [mesh_hydro], [mesh_elastic].  `ref`: [headline]'s
    rows, bounds and iterations.  Returns the launches by design."""
    import os
    import tempfile

    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    t0 = time.perf_counter()
    total = {}
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="nccl") as td:
        mesh_mod.init_multihost(f"file://{os.path.join(td, 'store')}", 1,
                                0, device="cuda")
        try:
            batch = sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS,
                               dev)
            merge_launches(total, mesh_nccl(batch, ref))
            torch.cuda.empty_cache()
            merge_launches(total, mesh_hydro(dev))
            merge_launches(total, mesh_elastic(batch, ref))
        finally:
            mesh_mod.shutdown()
    phase("mesh_path", seconds=round(time.perf_counter() - t0, 2),
          launches_by_design=json.dumps(total, sort_keys=True)
          .replace(" ", ""))
    return total


def ci_and_mesh_runs(xhat, inner, ref):
    """The CI worker's entry: the sslp confidence-interval phases, then
    the mesh phases.  Returns {"ci", "mesh"}: their launches by
    design."""
    return {"ci": ci_runs(xhat, inner), "mesh": mesh_runs(ref)}


def headline_ref(dev):
    """--only mesh: [headline] run here for its rows and bounds."""
    sync = {}
    headline(sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev),
             sync)
    h = sync["headline"]
    return {"rows": h["rows"], "bounds": h["bounds"],
            "iterations": h["iterations"]}


def fleet_alone():
    """--only fleet: [cli_headline] and [serve_headline] run here for
    [fleet_migrate]'s reference."""
    serve_headline(cli_headline_alone())
    return fleet_migrate(SERVED_HEADLINE)


def cli_headline_alone():
    """--only serve / serve_headline: [cli_headline] run here for the
    served headline's reference."""
    result, _, _, _ = cli_run("cli_headline", cli_capped(
        CLI_HEADLINE, "--max-iterations", CLI_HEADLINE_ITERS))
    return result


def headline_xhat(dev):
    """--only ci / ci_zhat: [headline] run here for its x̂ and inner
    bound."""
    sync = {}
    headline(sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev),
             sync)
    return sync["headline"]["xhat"], sync["headline"]["bounds"][1]


def credit(kernels, by_design):
    """Add main-path launches (by instantiation/mode/design) to the
    kernels line's entries: resident box bf16x3 -> K2, resident box f32
    -> K1, streamed box -> the streamed entry, split box and SOC -> the
    split entries, SOC by design."""
    names = {e["name"]: e for e in kernels}
    for key, count in by_design.items():
        inst, mode, design = key.split("/")
        if inst == "pdhg_window" and design == "resident":
            name = "pdhg_window" if mode == "bf16x3" else "pdhg_window_f32"
        elif design == "split":
            name = inst + "_split"
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
    if sys.argv[1:2] != ["--only"]:
        CPU_HALVES.start()
    try:
        return run(sys.argv[1:])
    finally:
        CPU_HALVES.close()
        for worker in (CARD_WORKER, CI_WORKER, MPC_WORKER, SERVE_WORKER):
            worker.close()


def run(argv) -> int:
    """Build the kernels and run the phases `argv` names (all of them
    without --only)."""
    from mpisppy_tpu_torch.ops import pdhg_window
    from mpisppy_tpu_torch.telemetry import roofline

    t_start = time.perf_counter()
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

    full = "--full" in argv
    only = {"headline_profile": headline_profile,
            "ccopf_profile": ccopf_profile,
            "window_time_split": split_path,
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
            "models": lambda dev: models_path(dev, full),
            "models_windows": models_windows,
            "hydro_small": hydro_small,
            "hydro_wheel": lambda dev: hydro_wheel(dev, full),
            "aircond": aircond_phase,
            "models_cli": lambda dev: models_cli(dev, full),
            "exact_candidates": exact_candidates,
            "usar_mip": usar_mip,
            "admm": admm_phase,
            "ext": lambda dev: ext_path(dev, {}),
            "ext_cli_headline": lambda dev: ext_cli_headline_alone(dev),
            "ext_sensi_mult": lambda dev: ext_sensi_mult(),
            "ext_bundles": lambda dev: ext_bundles(),
            "ci": lambda dev: (ci_runs(*headline_xhat(dev)),
                               ci_check(ci_small_runs())),
            "ci_zhat": lambda dev: ci_zhat(*headline_xhat(dev)),
            "ci_mmw": lambda dev: ci_mmw(),
            "ci_seq": lambda dev: ci_seq_check(ci_seq_card()[0]),
            "ci_mstage": lambda dev: ci_mstage_check(*ci_mstage_card()),
            "mpc": lambda dev: mpc_check(mpc_runs()),
            "mpc_ccopf": lambda dev: mpc_ccopf(),
            "mpc_uc_cli": lambda dev: mpc_uc_check(mpc_uc_cli()),
            "serve": lambda dev: serve_runs(cli_headline_alone()),
            "serve_headline": lambda dev: serve_headline(
                cli_headline_alone()),
            "serve_mix": lambda dev: serve_mix(),
            "serve_coalesce": lambda dev: serve_coalesce(),
            "serve_stream": lambda dev: serve_stream(),
            "fleet": lambda dev: fleet_alone(),
            "mesh": lambda dev: mesh_runs(headline_ref(dev)),
            **{name: (lambda dev, n=name: slice9_runs(
                slice9_table(full), n, CHECKS[n])) for name in CHECKS}}
    if argv[:1] == ["--only"]:
        for name in argv[1].split(","):
            only[name](dev)
        return 0
    normal_path(dev)
    sync = {}     # the results later phases compare with
    kernels = sslp_path(dev, sync)
    torch.cuda.empty_cache()
    kernels.extend(ccopf_path(dev, sync))
    torch.cuda.empty_cache()
    kernels.extend(split_path(dev))
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
    # the slice-9 CLI runs in the card worker, beside the MIP phases and
    # the extensions' (after every kernel timing and profile but
    # [mip_round_profile], which then shares the card with the worker's
    # launches)
    CARD_WORKER.start("slice9_cli_runs", full)
    # the slice-15 groups in two more card workers beside them (the CPU
    # comparisons here, after the join)
    CI_WORKER.start("ci_and_mesh_runs", sync["headline"]["xhat"],
                    sync["headline"]["bounds"][1],
                    {k: sync["headline"][k]
                     for k in ("rows", "bounds", "iterations")})
    # the serving phases in a card worker of their own, collected after
    # the models' phases: its session threads share the card with every
    # host loop until then
    SERVE_WORKER.start("serve_runs", sync["cli_headline"])
    MPC_WORKER.start("mpc_and_ci_small_runs")
    _, _, mip_launches = mip_path(dev)
    torch.cuda.empty_cache()
    ext_launches = ext_path(dev, sync)
    torch.cuda.empty_cache()
    slice9_windows(dev)
    slice9_launches = CARD_WORKER.result()
    ci_mesh = CI_WORKER.result()
    ci_launches, mesh_launches = ci_mesh["ci"], ci_mesh["mesh"]
    second = MPC_WORKER.result()
    mpc_launches = mpc_check(second["mpc"])
    merge_launches(ci_launches, ci_check(second["ci_small"]))
    torch.cuda.empty_cache()
    async_launches = async_path(dev, sync)
    torch.cuda.empty_cache()
    resilience_launches = resilience_path(dev, sync)
    torch.cuda.empty_cache()
    models_launches = models_path(dev, full)
    serve_launches = SERVE_WORKER.result()
    # [profile_cli]'s windows ran in K2 and K1 (its capped CLI headline);
    # the MIP phases' node LPs ran in K1 (f32); the slice-9 paths in K1,
    # K2 (APH's bf16x3), the split box design (L-shaped masters), the
    # streamed one (the cross-scenario view) and the split SOC design
    # (the root-fixed ccopf EF);
    # the async wheel's in K1, K2 (its bf16x3 stale-prox hub step) and
    # the resident SOC kernel (ccopf); the checkpointed headline's in K2
    # and K1; the models' in K2 (hydro's bf16x3 wheel) and K1 (its f32
    # spoke planes, aircond's program, the CLI runs, the exact candidates);
    # the extensions' in K2 (the headline flags with the gradient rho,
    # the warm start, XhatClosest's bf16x3 evaluation) and K1 (their f32
    # spoke planes, find_grad_cost, the S=64 sensi/mult runs)
    credit(kernels, profile_launches)
    credit(kernels, mip_launches)
    credit(kernels, slice9_launches)
    credit(kernels, async_launches)
    credit(kernels, resilience_launches)
    credit(kernels, models_launches)
    credit(kernels, ext_launches)
    credit(kernels, ci_launches)
    credit(kernels, mpc_launches)
    credit(kernels, serve_launches)
    credit(kernels, mesh_launches)
    # the split design's main path: the sampled EFs and the L-shaped
    # master (box rows), the root-fixed ccopf EFs (SOC rows)
    idle = [e["name"] for e in kernels
            if e["name"].endswith("_split") and e["launches"] == 0]
    if idle:
        raise AssertionError(f"no main-path launch of {idle}")
    phase("total", seconds=round(time.perf_counter() - t_start, 2))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
