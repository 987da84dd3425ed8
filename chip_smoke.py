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
  the sslp 15x45 VirtualBatch wheel at 10,000 scenarios;
* farmer — per-scenario A (yields enter A), so every window runs the
  plain batched iteration and no kernel: the fused wheel with all four
  fusable spokes at 3 scenarios on the card and on the CPU (bounds
  agree, inner bound at the EF value), then the farmer program's
  VirtualBatch wheel at 10,000 scenarios to a 1% certificate;
* the CLI — generic_cylinders.main in this process, as
  `python -m mpisppy_tpu_torch` runs it: the README's sslp command
  (without --presolve, cut to 10 hub iterations) against the JAX
  package's bounds for it, and the sslp 15x45 headline at 10,000
  scenarios with all four fusable spokes in bf16x3 to a 1% certificate,
  its box windows in the design the shape rule gives;

each wheel through WheelSpinner(hub_dict, spokes).spin(), with the launch
counts set to 0 just before it and read just after, to show that it went
through its kernel.  One line per phase; then one JSON line describing
each kernel, then the last line {"ok": true, "device": {...}}.  Any
failed check raises (exit code 1); without CUDA the script exits 2 and
prints no result.  `python3 chip_smoke.py --only headline_profile` (or
`--only ccopf_profile`, or `--only farmer_profile`: the farmer program's
wheel at 10,000 scenarios capped at 3 hub iterations) runs that profile
phase alone (to profile another tree's package with it).
"""
import json
import math
import re
import subprocess
import sys
import time

import torch

# Hopper peaks for the least-time bound (NVIDIA H100 SXM data sheet,
# dense): device memory 3.35 TB/s, f32 outside the tensor cores 67
# TFLOP/s, bf16 tensor cores 989 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

SSLP_SERVERS, SSLP_CLIENTS = 15, 45   # bench.py SSLP_SERVERS/CLIENTS
HEADLINE_SCENS = 10_000               # bench.py SSLP_SCENS
SWEEP_SCENS = (10_000, 100_000)       # bench.py SWEEP (full run)
N_ITERS = 40                          # restart_period of the headline
TAIL_SCENS, TAIL_ITERS = 64, 160      # the fused wheel's straggler tail
DESIGNS = ("resident", "streamed")    # the window kernel's two designs
HEADLINE_MAX_ITERS = 150              # cap: a few minutes on one H100
PROFILE_HUB_ITERS = 6                 # [headline_profile]'s capped run
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
# threefry2x32 operations per draw: 20 rounds of add, rotate (two shifts
# and an or) and xor, the key injections, and the bits-to-float and
# compare — integer work counted at the f32 CUDA-core rate
THREEFRY_OPS = 125
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
CLI_README = ["--module-name", "mpisppy_tpu_torch.models.sslp",
              "--num-scens", "100", "--lagrangian", "--xhatshuffle",
              "--rel-gap", "0.01",
              # cut: its 100 hub iterations take ~550 s on an H100 (a
              # to-tolerance solve per spoke and sync) and, in the JAX
              # package too, end at rel_gap 0.416 (rho 1)
              "--max-iterations", "10"]
# the JAX package's CLI on the CPU, the same command (python -m
# mpisppy_tpu --module-name mpisppy_tpu.models.sslp ... --max-iterations
# 10): (outer, inner); the port's must agree to 1e-3 relative
CLI_README_JAX_BOUNDS = (-216.44847106933594, -149.89996337890625)
CLI_HEADLINE = ["--module-name", "mpisppy_tpu_torch.models.sslp",
                "--n-servers", str(SSLP_SERVERS), "--n-clients",
                str(SSLP_CLIENTS), "--num-scens", str(HEADLINE_SCENS),
                "--fused-wheel", "--lagrangian", "--xhatxbar",
                "--xhatshuffle", "--slammin", "--iter-precision", "bf16x3",
                "--rel-gap", "0.01",
                # the headline's own configuration (bench_sslp_gap)
                "--default-rho", "20", "--sslp-lp-relax",
                "--max-iterations", str(HEADLINE_MAX_ITERS)]


def phase(name, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {parts}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


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


def window_inputs(batch, seed=0):
    """A mid-solve window input at the batch's shapes: two cold windows
    from init_state (through the kernel), per-scenario step sizes from
    the solver's omega/Lnorm, every 7th lane done."""
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
    done[::7] = True
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


def stored_bytes(t):
    """Bytes an input holds: a stride-0 (S, k) view (a shared row
    expanded over the batch) is read as its one row."""
    if t.ndim == 2 and t.stride(0) == 0:
        t = t[0]
    return t.numel() * t.element_size()


def window_bound_ms(args, mode, synth=None):
    """Least time one window could take on an H100: the larger of the
    bytes it must move (each input read once, each output written once)
    over the memory rate, and its operations over the peak rate of
    their type (bf16 products at the tensor-core rate in bf16x3 mode).
    SOC rows add about 6 flops each per iteration (shift, square, sum,
    scale, subtract, window sum) and each block a sqrt and a divide.
    With `synth` the drawn rows are not read: bl/bu are the shared
    template rows, d_row is read once, and each scenario pays one key
    fold and one draw per drawn row (THREEFRY_OPS each)."""
    qp, x, y = args[0], args[1], args[2]
    S, n = x.shape
    m = y.shape[1]
    it = args[8]
    ins = [qp.A, qp.c, qp.q, qp.l, qp.u, qp.bl, qp.bu] + list(args[1:8])
    if qp.cones is not None:
        ins += list(qp.cones.csr(x.device))
    if synth is not None:
        ins.append(synth.d_row)
    nbytes = sum(stored_bytes(t) for t in ins) \
        + 2 * (x.numel() + y.numel()) * 4
    mac_flops = 4.0 * m * n * S * it            # A'y and A v per iteration
    elem_flops = (9.0 * n + 6.0 * m) * S * it   # prox, clips, sums
    if synth is not None:
        elem_flops += THREEFRY_OPS * (1 + synth.draws.count) * S
    if qp.cones is not None:
        soc_rows = int(qp.cones.is_soc.sum())
        elem_flops += (6.0 * soc_rows + 2.0 * qp.cones.num_cones) * S * it
    if mode == "bf16x3":
        t_ops = 3 * mac_flops / BF16_FLOPS + elem_flops / F32_FLOPS
    else:
        t_ops = (mac_flops + elem_flops) / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def wheel(batch, opts):
    """The fused PH wheel (PH hub, fused Lagrangian and x̂-x̄ spokes) to
    a 1% gap; returns the spinner and its wall seconds."""
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 0.01}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions()}}
    spokes = [{"spoke_class": spoke.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke.FusedXhatXbarInnerBound,
               "opt_kwargs": {"options": {}}}]
    t0 = time.perf_counter()
    ws = WheelSpinner(hub, spokes).spin()
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


def main_wheel(label, kernel, batch, opts, slack=0.0, **fields):
    """Drive one main path with the launch counts set to 0 just before
    and read just after; its kernel must have launched, and its bounds
    be finite and ordered (outer <= inner + slack * max(1, |inner|)).
    Returns the spinner, the launches by instantiation and the launches
    by instantiation/mode/design."""
    from mpisppy_tpu_torch.ops import pdhg_window
    reset_launches()
    ws, secs = wheel(batch, opts)
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
    hub iterations)."""
    if batch is None:
        batch = sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    profile_wheel("headline_profile", batch, lambda: wheel(
        batch, sslp_options("bf16x3", PROFILE_HUB_ITERS, 1e-6, 8)))


def ccopf_profile(dev, batch=None):
    """profile_wheel over a capped run of the ccopf (100,100) wheel
    (CCOPF_PROFILE_HUB_ITERS hub iterations)."""
    if batch is None:
        batch = ccopf_batch(CCOPF_BFS, dev)
    profile_wheel("ccopf_profile", batch, lambda: wheel(
        batch, ccopf_options(CCOPF_PROFILE_HUB_ITERS)))


def profile_wheel(label, batch, run):
    """torch.profiler over one wheel run (run() returns the spinner and
    its wall seconds): the device busy share (union of device activity
    over the run's wall time), the window kernel's share of device time
    by mode and design, and the top five other kernels.  The same run
    without the profiler goes first (it also warms up); its wall time
    shows what the profiler adds on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, plain_secs = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ws, secs = run()
    spans, by_kernel = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start)
    device_us = sum(by_kernel.values())
    if device_us <= 0.0:
        # the profiler saw no device activity: time the same run with
        # CUDA events instead (no busy share, no split by kernel)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        _, secs = run()
        t1.record()
        torch.cuda.synchronize()
        phase(label, profiler_device_time=0,
              event_ms=round(t0.elapsed_time(t1), 3),
              wall_s=round(secs, 3))
        return
    spans.sort()
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
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
          device_busy_share=round(busy / (secs * 1e6), 4),
          window_share=json.dumps({k: round(v, 4) for k, v in
                                   sorted(shares.items())}).replace(" ", ""),
          window_ms=json.dumps({k: round(v / 1e3, 3) for k, v in
                                sorted(window.items())}).replace(" ", ""))
    for name, us in top:
        phase(label, other_kernel=f"'{name[:90]}'",
              ms=round(us / 1e3, 3), share=round(us / device_us, 4))


def sslp_path(dev):
    """The sslp phases: the resident kernel against its plain version at
    S=10,000 and at the straggler tail's shape, the streamed body at
    S=10,000, the tensor-core accumulation error, window times of both
    designs, the S=64 wheel on card and CPU, the profile of a capped
    headline run, and the sslp 15x45 headline at S=10,000."""
    batch = sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    args = window_inputs(batch)
    tail = sslp_batch(TAIL_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    tail_args = window_inputs(tail, seed=1)[:8] + (TAIL_ITERS,)
    del tail
    errs = {}
    for mode in ("f32", "bf16x3"):
        errs[mode] = parity(args, mode, "parity", HEADLINE_SCENS,
                            design="resident")[0]
        parity(tail_args, mode, "parity", TAIL_SCENS, design="resident")
        parity(args, mode, "parity", HEADLINE_SCENS, design="streamed")
    mma_accumulation(batch.qp)
    timing = window_times(args, "window_time", SWEEP_SCENS, DESIGNS)
    timing.update(time_designs(tail_args, "window_time", DESIGNS, reps=20,
                               shape="tail"))

    small_wheel("wheel_small", "sslp_5_15", sslp_batch(64, 5, 15, dev),
                sslp_batch(64, 5, 15, "cpu"),
                sslp_options(None, 200, 1e-7, 10))

    headline_profile(dev, batch)
    # the headline: sslp 15x45, 10,000 scenarios, bench_sslp_gap's
    # options, through the kernels the shape rule picks
    _, _, by_design = main_wheel(
        "headline", "pdhg_window", batch,
        sslp_options("bf16x3", HEADLINE_MAX_ITERS, 1e-6, 8),
        model="sslp_15_45", iter_precision="bf16x3")
    check_designs("headline", by_design, batch.qp.m, batch.qp.n,
                  (HEADLINE_SCENS, TAIL_SCENS))
    return [kernel_entry(name, RESIDENT_SOURCE,
                         f"mpisppy_tpu/ops/pdhg_pallas.py:{line}",
                         by_design[f"pdhg_window/{mode}/resident"],
                         errs[mode], timing[HEADLINE_SCENS, mode, "resident"])
            for name, mode, line in (("pdhg_window", "bf16x3", 663),
                                     ("pdhg_window_f32", "f32", 491))]


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


def ccopf_path(dev):
    """The ccopf --soc phases: SOC-window parity (ccopf at S=10,000 and
    the 64 x 160 tail in the shape rule's design, the 33-bus feeder on
    the streamed design), window times of both designs, the (3,3) wheel
    on card and CPU, the profile of a capped (100,100) wheel, and the
    (100,100) wheel at S=10,000."""
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
    errs = {}
    for mode in ("f32", "bf16x3"):
        errs[mode] = soc_parity(args, mode, S, batch.qp, model="ccopf_soc")
        soc_parity(tail_args, mode, TAIL_SCENS, tail.qp, model="ccopf_soc")
        soc_parity(args, mode, S, batch.qp, design="streamed",
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
    nodes = ws.spcomm.best_nonants().shape[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        (ws.BestOuterBound, ws.BestInnerBound), CCOPF_JAX_BOUNDS))
    phase("ccopf_soc", best_nonants_rows=nodes,
          jax_outer=CCOPF_JAX_BOUNDS[0], jax_inner=CCOPF_JAX_BOUNDS[1],
          max_rel_diff_vs_jax=rel)
    if nodes != batch.tree.num_nodes or rel > 1e-3:
        raise AssertionError("ccopf_soc: not one best_nonants row per tree "
                             "node, or bounds off the JAX reference")
    return kernel_entry("pdhg_window_soc", CONES_SOURCE,
                        "mpisppy_tpu/ops/pdhg_pallas.py:192",
                        by_design["pdhg_window_soc/f32/resident"],
                        errs["f32"], timing[S, "f32", "resident"])


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


def cli_run(label, args):
    """generic_cylinders.main(args) in this process, on the card, with
    the launch counts set to 0 just before and read just after.  The
    CLI's own JSON result line is captured and printed as fields of this
    phase's line.  Returns (its JSON result, launches by instantiation,
    launches by design, the spinner)."""
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
    phase(label, S=ws.opt.batch.num_scenarios,
          device=ws.opt.batch.device.type, hub_iters=result["iterations"],
          outer=result["outer_bound"], inner=result["inner_bound"],
          rel_gap=result["rel_gap"], wall_s=round(secs, 3),
          kernel_launches=launches["pdhg_window"],
          all_launches=json.dumps(launches).replace(" ", ""),
          by_design=json.dumps(by_design, sort_keys=True).replace(" ", ""))
    outer, inner = result["outer_bound"], result["inner_bound"]
    if ws.opt.batch.device.type != "cuda" or outer is None or inner is None \
            or outer > inner or launches["pdhg_window"] <= 0:
        raise AssertionError(f"{label}: not on the card, bounds missing or "
                             "crossed, or no box-kernel launches")
    return result, launches, by_design, ws


def cli_path():
    """The CLI phases: the README's sslp command (without --presolve:
    classic Lagrangian and shuffle spokes, S=100, sslp 5x25 with integer
    first stage; cut to 10 hub iterations) against the JAX package's
    bounds for the same command, then the sslp 15x45 headline at
    S=10,000 through the CLI with all four fusable spokes in bf16x3 to
    a 1% certificate, every box window in the design the shape rule
    gives."""
    result, _, _, _ = cli_run("cli_readme", CLI_README)
    rel = max(abs(result[k] - j) / abs(j) for k, j in zip(
        ("outer_bound", "inner_bound"), CLI_README_JAX_BOUNDS))
    phase("cli_readme", jax_outer=CLI_README_JAX_BOUNDS[0],
          jax_inner=CLI_README_JAX_BOUNDS[1], max_rel_diff_vs_jax=rel)
    if rel > 1e-3:
        raise AssertionError("cli_readme: bounds off the JAX reference")
    result, _, by_design, ws = cli_run("cli_headline", CLI_HEADLINE)
    if not result["rel_gap"] <= 0.01:
        raise AssertionError("cli_headline: no 1% certificate")
    qp = ws.opt.batch.qp
    check_designs("cli_headline", by_design, qp.m, qp.n,
                  (HEADLINE_SCENS, TAIL_SCENS))


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
        sslp_options("bf16x3", HEADLINE_MAX_ITERS, 1e-6, 8),
        model="sslp_15_45_scengen", iter_precision="bf16x3")
    if not ws.spcomm.compute_gaps()[1] <= 0.01:
        raise AssertionError("scengen_wheel: no 1% certificate")
    check_designs("scengen_wheel", by_design, vb.qp.m, vb.qp.n,
                  (HEADLINE_SCENS, TAIL_SCENS))
    return kernel_entry("pdhg_window_synth", RESIDENT_SOURCE,
                        "mpisppy_tpu/ops/pdhg_pallas.py:624", launches,
                        errs["bf16x3"], timing[S_big, "bf16x3"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from mpisppy_tpu_torch.ops import pdhg_window

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # the card
    phase("card", nvidia_smi=f"'{card_line()}'", torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(card_line(), flush=True)

    # build the kernel (every instantiation) from this checkout's sources
    t0 = time.perf_counter()
    log = pdhg_window.build()
    phase("build", sources=",".join(
              str(p.relative_to(pdhg_window.CSRC.parents[1]))
              for p in pdhg_window.SOURCES),
          seconds=round(time.perf_counter() - t0, 2),
          ptxas_registers=registers_by_instantiation(log))

    only = {"headline_profile": headline_profile,
            "ccopf_profile": ccopf_profile,
            "farmer_profile": farmer_profile}
    if sys.argv[1:2] == ["--only"]:
        only[sys.argv[2]](dev)
        return 0
    kernels = sslp_path(dev)
    torch.cuda.empty_cache()
    kernels.append(ccopf_path(dev))
    torch.cuda.empty_cache()
    kernels.append(scengen_path(dev))
    torch.cuda.empty_cache()
    farmer_path(dev)
    torch.cuda.empty_cache()
    cli_path()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
