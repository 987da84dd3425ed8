"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version at the main path's shapes, runs a
small wheel on the card and on the CPU and compares their bounds, then
drives the headline workload — the sslp 15x45 fused PH wheel at 10,000
scenarios — through WheelSpinner(hub_dict, spokes).spin() and shows
that it went through the kernel.  One line per phase; then one JSON line
describing each kernel, then the last line
{"ok": true, "device": {...}}.  Any failed check raises (exit code 1);
without CUDA the script exits 2 and prints no result.
"""
import json
import math
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
HEADLINE_MAX_ITERS = 150              # cap: a few minutes on one H100
# kernel vs plain version, max |k - r| <= ATOL + RTOL * |r| after one
# window: f32 differs only in summation order (~1e-6 measured); bf16x3
# splits a value whose last bits differ, so its terms move by ~2^-16
TOLS = {"f32": (1e-4, 1e-4), "bf16x3": (1e-3, 1e-3)}


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


def tiled(args, reps):
    """The same window inputs repeated `reps` times along the scenario
    axis (the S=100,000 sweep shape without building 100,000 specs)."""
    import dataclasses
    qp = args[0]

    def rep(t):
        return t.repeat((reps,) + (1,) * (t.ndim - 1)).contiguous()
    qp = dataclasses.replace(qp, c=rep(qp.c), q=rep(qp.q), bl=rep(qp.bl),
                             bu=rep(qp.bu))
    return (qp,) + tuple(rep(t) for t in args[1:8]) + (args[8],)


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


def window_bound_ms(args, mode):
    """Least time one window could take on an H100: the larger of the
    bytes it must move (each input read once, each output written once)
    over the memory rate, and its operations over the peak rate of
    their type (bf16 products at the tensor-core rate in bf16x3 mode)."""
    qp, x, y = args[0], args[1], args[2]
    S, n = x.shape
    m = y.shape[1]
    it = args[8]
    ins = [qp.A, qp.c, qp.q, qp.l, qp.u, qp.bl, qp.bu] + list(args[1:8])
    nbytes = sum(t.numel() * t.element_size() for t in ins) \
        + 2 * (x.numel() + y.numel()) * 4
    mac_flops = 4.0 * m * n * S * it            # A'y and A v per iteration
    elem_flops = (9.0 * n + 6.0 * m) * S * it   # prox, clips, sums
    if mode == "bf16x3":
        t_ops = 3 * mac_flops / BF16_FLOPS + elem_flops / F32_FLOPS
    else:
        t_ops = (mac_flops + elem_flops) / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def wheel(batch, iter_precision, max_iterations, tol, subproblem_windows):
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.cylinders import spoke
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    opts = ph_mod.PHOptions(
        default_rho=20.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=subproblem_windows,
        pdhg=pdhg.PDHGOptions(tol=tol, restart_period=N_ITERS,
                              iter_precision=iter_precision))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from mpisppy_tpu_torch.ops import pdhg_window

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    phase("card", nvidia_smi=f"'{card_line()}'", torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(card_line(), flush=True)

    # 2. build the kernel from this checkout's sources
    t0 = time.perf_counter()
    log = pdhg_window.build()
    regs = sorted({ln.split("Used ")[1].split(",")[0]
                   for ln in log.splitlines() if "registers" in ln})
    phase("build", source="mpisppy_tpu_torch/csrc/pdhg_window.cu",
          seconds=round(time.perf_counter() - t0, 2),
          ptxas_registers="/".join(regs))

    # 3. kernel against its plain version at the main path's shapes
    batch = sslp_batch(HEADLINE_SCENS, SSLP_SERVERS, SSLP_CLIENTS, dev)
    args = window_inputs(batch)
    errs = {}
    for mode in ("f32", "bf16x3"):
        k = pdhg_window.run_window(*args, precision=mode)
        r = pdhg_window.run_window_reference(*args, precision=mode)
        torch.cuda.synchronize()
        err, ok = max_err(k, r, mode)
        done = args[7]
        frozen = torch.equal(k[0][done], args[1][done]) \
            and torch.equal(k[1][done], args[2][done])
        phase("parity", S=HEADLINE_SCENS, mode=mode, max_abs_err=err,
              tol=f"{TOLS[mode][0]}+{TOLS[mode][1]}*|plain|", ok=ok,
              done_lanes_unchanged=frozen)
        if not (ok and frozen):
            raise AssertionError(f"window kernel disagrees ({mode})")
        errs[mode] = err
    tail = sslp_batch(64, SSLP_SERVERS, SSLP_CLIENTS, dev)
    targs = window_inputs(tail, seed=1)
    err, ok = max_err(pdhg_window.run_window(*targs, precision="bf16x3"),
                      pdhg_window.run_window_reference(*targs,
                                                       precision="bf16x3"),
                      "bf16x3")
    phase("parity", S=64, mode="bf16x3", max_abs_err=err,
          tol=f"{TOLS['bf16x3'][0]}+{TOLS['bf16x3'][1]}*|plain|", ok=ok)
    if not ok:
        raise AssertionError("window kernel disagrees at the tail shape")

    timing = {}
    for S in SWEEP_SCENS:
        a = args if S == HEADLINE_SCENS else tiled(args, S // HEADLINE_SCENS)
        for mode in ("f32", "bf16x3"):
            ms = time_ms(lambda: pdhg_window.run_window(*a, precision=mode))
            plain = time_ms(lambda: pdhg_window.run_window_reference(
                *a, precision=mode), reps=2)
            bound, by = window_bound_ms(a, mode)
            timing[S, mode] = (ms, plain, bound, by)
            phase("window_time", S=S, mode=mode, n_iters=N_ITERS,
                  kernel_ms=round(ms, 3), plain_ms=round(plain, 3),
                  bound_ms=round(bound, 4), bound_by=by)
        del a
    torch.cuda.empty_cache()

    # 4. small wheel on the card and on the CPU: same batch, same bounds
    small_gpu = sslp_batch(64, 5, 15, dev)
    small_cpu = sslp_batch(64, 5, 15, "cpu")
    g, g_s = wheel(small_gpu, None, 200, 1e-7, 10)
    c, c_s = wheel(small_cpu, None, 200, 1e-7, 10)
    g_gap = g.spcomm.compute_gaps()[1]
    rel = [abs(a - b) / abs(b) for a, b in
           ((g.BestOuterBound, c.BestOuterBound),
            (g.BestInnerBound, c.BestInnerBound))]
    phase("wheel_small", S=64, model="sslp_5_15", gpu_iters=g.spcomm._iter,
          cpu_iters=c.spcomm._iter, outer=g.BestOuterBound,
          inner=g.BestInnerBound, rel_gap=g_gap,
          cpu_outer=c.BestOuterBound, cpu_inner=c.BestInnerBound,
          max_rel_diff=max(rel), gpu_s=round(g_s, 2), cpu_s=round(c_s, 2))
    if not (g_gap <= 0.01 and max(rel) <= 1e-3):
        raise AssertionError("small wheel: no 1% certificate on the card, "
                             "or bounds disagree with the CPU run")

    # 5. the headline: sslp 15x45, 10,000 scenarios, bench_sslp_gap's
    #    options, through the kernel
    del small_gpu, small_cpu, g, c
    pdhg_window.run_window.launches = 0
    ws, secs = wheel(batch, "bf16x3", HEADLINE_MAX_ITERS, 1e-6, 8)
    launches = pdhg_window.run_window.launches
    outer, inner = ws.BestOuterBound, ws.BestInnerBound
    rel_gap = ws.spcomm.compute_gaps()[1]
    phase("headline", model="sslp_15_45", S=HEADLINE_SCENS,
          iter_precision="bf16x3", iterations=ws.spcomm._iter, outer=outer,
          inner=inner, rel_gap=rel_gap, certified=rel_gap <= 0.01,
          seconds=round(secs, 2), kernel_launches=launches,
          launches_per_hub_iter=round(launches / max(1, ws.spcomm._iter), 2))
    if not (launches > 0 and math.isfinite(outer) and math.isfinite(inner)
            and outer <= inner):
        raise AssertionError("headline wheel: no kernel launches, or "
                             "bounds not finite and ordered")

    # 6. the kernels
    ms, plain, bound, by = timing[HEADLINE_SCENS, "bf16x3"]
    print(json.dumps({"kernels": [{
        "name": "pdhg_window",
        "route": "cuda",
        "source": "mpisppy_tpu_torch/csrc/pdhg_window.cu",
        "replaces": "mpisppy_tpu/ops/pdhg_pallas.py:663",
        "launches": launches,
        "max_abs_err": errs["bf16x3"],
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
