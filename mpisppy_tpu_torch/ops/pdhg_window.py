###############################################################################
# The PDHG restart window: n_iters PDHG iterations per scenario against a
# shared dense A, as one hand-written CUDA kernel (csrc/pdhg_window.cu)
# with its plain PyTorch version beside it.
#
# Replaces mpisppy_tpu/ops/pdhg_pallas.py::run_window — the Pallas TPU
# kernel (_tile_math, run through either the single-buffer grid kernel or
# the double-buffered pipeline; both compute the same function, so one
# CUDA kernel ports both), box rows and the SOC dual prox
# (_tile_math.soc_prox) alike.  The kernel has three instantiations,
# counted apart in run_window.launches: "pdhg_window" (box rows only),
# "pdhg_window_soc" (a batch with second-order-cone blocks) and
# "pdhg_window_synth" (box rows whose drawn bound rows the kernel
# synthesizes itself from threefry keys: run_window(synth=TileSynth),
# the port of the Pallas engine's in-kernel tile synthesis).
#
# What bounds it on an H100: per iteration a scenario does 4*m*n flops
# of matvec against A (2 reads of A) and O(n + m) elementwise work.  The
# kernel keeps each scenario's state in shared memory for the whole
# window, so device memory sees each input once and each output once;
# A (165 KiB at sslp 15x45) stays in L2, and several scenarios share one
# block so each A element read feeds several multiply-adds.  What is left
# is L2 and shared-memory traffic per multiply-add; A resident in shared
# memory and tensor-core products are later work (ROADMAP.md queue B).
#
# Rule: run_window takes the plain version only for CPU tensors.  For
# CUDA tensors it launches the kernel or raises — there is no fallback.
# The kernel is compiled with nvcc for sm_90a at first use into
# mpisppy_tpu_torch/_build/ and loaded with ctypes.
###############################################################################
from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
from pathlib import Path

import torch

from mpisppy_tpu_torch.ops import cones as cones_mod
from mpisppy_tpu_torch.ops.boxqp import BoxQP, as_precision

Tensor = torch.Tensor

_BIG = 1e30  # finite stand-in for +-inf row bounds (0 * inf would be NaN)
_MODES = {"f32": 0, "bf16": 1, "bf16x3": 3}

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "pdhg_window.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libpdhg_window.so"
BUILD_LOG = BUILD_DIR / "pdhg_window.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


@dataclasses.dataclass(frozen=True)
class TileSynth:
    """In-kernel synthesis of a program's drawn bound rows (port of
    pdhg_pallas.TileSynth; built by scengen.window_inputs).  Scenario row
    s of the window draws program index min(s, num_real - 1) + start from
    the key fold_in(base_key, index) by the rule `draws`
    (scengen.program.RowDraws), scales the drawn values by d_row and
    writes them over the shared template rows of draws.fields.  The
    kernel takes the key from here, never from a generator of its own.

    key: the program's base key as two ints (its threefry key words);
    d_row: (m,) f32 row scaling; start, num_real: the program's index
    window."""

    key: tuple
    d_row: Tensor
    start: int
    num_real: int
    draws: object

    def scenario_indices(self, S: int, device) -> Tensor:
        i = torch.arange(S, device=device)
        return torch.clamp(i, max=self.num_real - 1) + self.start

    def synthesize(self, p: BoxQP, S: int) -> BoxQP:
        """The plain version of the kernel's load phase: p with its drawn
        fields realized as (S, m) rows for all S scenarios."""
        rd = self.draws
        dev = p.A.device
        key = torch.tensor(self.key, dtype=torch.int64, device=dev)
        vals = rd.draw(key, self.scenario_indices(S, dev))
        rows = slice(rd.row0, rd.row0 + rd.count)
        scaled = vals * self.d_row.to(dev)[rows]
        out = {}
        for name in rd.fields:
            full = getattr(p, name)
            full = full.expand(S, full.shape[-1]).clone()
            full[:, rows] = scaled
            out[name] = full
        return dataclasses.replace(p, **out)


def supported(p: BoxQP) -> bool:
    """The kernel's scope: a (S,)-batched problem with one dense shared
    (m, n) constraint matrix, box rows and any second-order-cone
    blocks."""
    return p.A.ndim == 2 and p.c.ndim == 2


def _split_bf16(v: Tensor) -> tuple[Tensor, Tensor]:
    """v ~= hi + lo with hi, lo bf16-representable (kept as f32).  Eager
    torch does not fold the f32 -> bf16 -> f32 round trip, so a plain
    cast is exact here (the JAX package needed reduce_precision)."""
    hi = v.to(torch.bfloat16).float()
    lo = (v - hi).to(torch.bfloat16).float()
    return hi, lo


def _matmul(mode: str, v: Tensor, M: Tensor, M_hi: Tensor, M_lo: Tensor):
    """v @ M in the kernel's arithmetic: f32, one bf16 product (hi*hi),
    or the three-product bf16 split accumulated in f32."""
    if mode == "f32":
        return v @ M
    v_hi, v_lo = _split_bf16(v)
    acc = v_hi @ M_hi
    if mode == "bf16x3":
        acc = acc + v_hi @ M_lo
        acc = acc + v_lo @ M_hi
    return acc


def run_window_reference(p: BoxQP, x: Tensor, y: Tensor, x_sum: Tensor,
                         y_sum: Tensor, tau: Tensor, sigma: Tensor,
                         done: Tensor, n_iters: int, precision=None,
                         synth: TileSynth | None = None):
    """The plain PyTorch version: the hoisted iteration of
    pdhg_pallas._tile_math written out (tc, pre, sbl, sbu).  On SOC rows
    y1 = Proj_polar(w - sigma*b), with b read from bl (bl == bu there).
    With `synth`, the drawn rows are first realized for every scenario
    (TileSynth.synthesize).  Returns (x, y, x_sum, y_sum)."""
    _check_synth(p, synth)
    if synth is not None:
        p = synth.synthesize(p, x.shape[0])
    mode = as_precision(precision) or "f32"
    live = 1.0 - done.to(x.dtype)
    t = (tau * live)[:, None]
    s = (sigma * live)[:, None]
    # done lanes run with tau = sigma = 0 and keep their iterates bit for
    # bit, while the window sums keep accumulating
    frozen = done[:, None]
    tc = t * p.c
    pre = 1.0 / (1.0 + t * p.q)
    sbl = s * torch.clamp(p.bl, -_BIG, _BIG)
    sbu = s * torch.clamp(p.bu, -_BIG, _BIG)
    spec = p.cones
    if spec is not None:
        ssh = s * torch.where(spec.is_soc, p.bl, torch.zeros_like(p.bl))
    A, AT = p.A, p.A.T
    A_hi, A_lo = _split_bf16(A) if mode != "f32" else (None, None)
    AT_hi = None if A_hi is None else A_hi.T
    AT_lo = None if A_lo is None else A_lo.T
    xs, ys = x_sum, y_sum
    for _ in range(n_iters):
        aty = _matmul(mode, y, A, A_hi, A_lo)              # A'y  (S, n)
        x1 = torch.where(frozen, x,
                         torch.clamp((x - t * aty - tc) * pre, p.l, p.u))
        ax = _matmul(mode, 2.0 * x1 - x, AT, AT_hi, AT_lo)  # A v (S, m)
        w = y + s * ax
        y1 = w - torch.clamp(w, sbl, sbu)
        if spec is not None:
            y1 = torch.where(spec.is_soc,
                             cones_mod.project_polar_rows(spec, w - ssh), y1)
        y1 = torch.where(frozen, y, y1)
        xs = xs + x1
        ys = ys + y1
        x, y = x1, y1
    return x, y, xs, ys


def _library():
    """Build (at first use, when missing or older than the source) and
    load the kernel's shared library."""
    global _lib
    if _lib is not None:
        return _lib
    if (not LIBRARY.exists()
            or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime):
        build()
    lib = ctypes.CDLL(str(LIBRARY))
    fn = lib.pdhg_window_launch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    U, F = ctypes.c_uint, ctypes.c_float
    fn.argtypes = ([P, P, I, I, I, I, I, P, P, P] + [P, L] * 6
                   + [P, P, I, I] + [P] * 8
                   + [U, U, I, I, I, I, F, F, F, I, I, P, P])
    fn.restype = I
    _lib = lib
    return lib


def build() -> str:
    """Compile csrc/pdhg_window.cu with nvcc for sm_90a into BUILD_DIR.
    Returns the compiler's output (ptxas register/shared-memory lines)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libpdhg_window.{os.getpid()}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + res.stdout + res.stderr
    BUILD_LOG.write_text(log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{log}")
    os.replace(tmp, LIBRARY)
    return log


def _check_synth(p: BoxQP, synth) -> None:
    if synth is not None and p.cones is not None:
        raise ValueError("TileSynth does not support conic batches")


def _shared_row(t: Tensor) -> Tensor:
    """A stride-0 (S, k) view (a shared row expanded over the batch, as
    VirtualBatch.realize gives c and q) as the shared (k,) row itself."""
    if t.ndim == 2 and t.shape[0] > 0 and t.stride(0) == 0:
        return t[0]
    return t


def _stride(t: Tensor, S: int) -> int:
    """Scenario stride of a (S, k) or shared (k,) operand."""
    if t.ndim == 1:
        return 0
    if t.shape[0] != S:
        raise ValueError(f"operand has {t.shape[0]} scenarios, expected {S}")
    return t.shape[1]


def run_window(p: BoxQP, x: Tensor, y: Tensor, x_sum: Tensor,
               y_sum: Tensor, tau: Tensor, sigma: Tensor, done: Tensor,
               n_iters: int, precision=None,
               synth: TileSynth | None = None):
    """n_iters PDHG iterations over the whole scenario batch.  Returns
    (x, y, x_sum, y_sum).  Shapes: x,c,q (S, n); y (S, m); tau/sigma/done
    (S,); A (m, n) shared; l/u/bl/bu shared or per-scenario (a stride-0
    (S, k) view counts as shared).  `synth` (box rows only): the kernel
    draws the TileSynth's rows itself (scengen.window_inputs builds
    both p and synth from a VirtualBatch).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in run_window.launches under the instantiation's name) or
    raise."""
    _check_synth(p, synth)
    if x.device.type == "cpu":
        return run_window_reference(p, x, y, x_sum, y_sum, tau, sigma,
                                    done, n_iters, precision, synth)
    if x.device.type != "cuda":
        raise ValueError(f"run_window: unsupported device {x.device}")
    if not supported(p):
        raise NotImplementedError(
            "the CUDA window kernel takes a batched problem with one dense "
            "shared A; per-scenario A and ELL are not ported yet")
    mode = as_precision(precision) or "f32"
    S, n = x.shape
    m = y.shape[-1]
    p = dataclasses.replace(p, **{f: _shared_row(getattr(p, f))
                                  for f in ("c", "q", "l", "u", "bl", "bu")})
    fields = (p.A, p.c, p.q, p.l, p.u, p.bl, p.bu, x, y, x_sum, y_sum,
              tau, sigma)
    for t in fields:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("run_window: every operand must be a "
                             "contiguous float32 tensor on one CUDA device")
    if done.device != x.device:
        raise ValueError("run_window: done must lie on the CUDA device")
    if p.A.shape != (m, n) or y.shape != (S, m) or x_sum.shape != (S, n) \
            or y_sum.shape != (S, m) or tau.shape != (S,) \
            or sigma.shape != (S,) or done.shape != (S,):
        raise ValueError("run_window: inconsistent operand shapes")
    for t, width in ((p.c, n), (p.q, n), (p.l, n), (p.u, n),
                     (p.bl, m), (p.bu, m)):
        if t.shape[-1] != width or t.ndim > 2:
            raise ValueError("run_window: inconsistent operand shapes")
    spec = p.cones
    if spec is not None and spec.num_cones > 0:
        if spec.m != m or spec.device != x.device:
            raise ValueError("run_window: the cone spec must cover the m "
                             "rows and lie on the CUDA device")
        cone_ptr, cone_rows = spec.csr(x.device)
        kernel = "pdhg_window_soc"
    else:
        cone_ptr = cone_rows = None
        kernel = "pdhg_window"
    done_f = done.to(torch.float32).contiguous()
    if mode == "f32":
        A_main, A_lo = p.A, None
    else:
        A_main, A_lo = _split_bf16(p.A)
        if mode == "bf16":
            A_lo = None
    xo, yo = torch.empty_like(x), torch.empty_like(y)
    xso, yso = torch.empty_like(x_sum), torch.empty_like(y_sum)
    if synth is not None:
        kernel = "pdhg_window_synth"
        rd = synth.draws
        d_row = synth.d_row
        if d_row.device != x.device or d_row.dtype != torch.float32 \
                or d_row.shape != (m,) or not d_row.is_contiguous():
            raise ValueError("run_window: synth.d_row must be a contiguous "
                             "float32 (m,) tensor on the CUDA device")
        if not (0 <= rd.row0 and rd.row0 + rd.count <= m):
            raise ValueError("run_window: synth draws rows outside [0, m)")
        draws = (*synth.key, int(synth.start), int(synth.num_real),
                 int(rd.row0), int(rd.count), float(rd.threshold),
                 float(rd.below), float(rd.above), int("bl" in rd.fields),
                 int("bu" in rd.fields), d_row.data_ptr())
    else:
        # d_row = null: no synthesis
        draws = (0, 0, 0, 0, 0, 0, 0.0, 0.0, 0.0, 0, 0, None)
    lib = _library()
    ptr = ctypes.c_void_p
    rc = lib.pdhg_window_launch(
        ptr(A_main.data_ptr()), ptr(0 if A_lo is None else A_lo.data_ptr()),
        m, n, S, int(n_iters), _MODES[mode],
        ptr(tau.data_ptr()), ptr(sigma.data_ptr()), ptr(done_f.data_ptr()),
        ptr(p.c.data_ptr()), _stride(p.c, S),
        ptr(p.q.data_ptr()), _stride(p.q, S),
        ptr(p.l.data_ptr()), _stride(p.l, S),
        ptr(p.u.data_ptr()), _stride(p.u, S),
        ptr(p.bl.data_ptr()), _stride(p.bl, S),
        ptr(p.bu.data_ptr()), _stride(p.bu, S),
        ptr(0 if cone_ptr is None else cone_ptr.data_ptr()),
        ptr(0 if cone_rows is None else cone_rows.data_ptr()),
        0 if cone_ptr is None else spec.num_cones,
        0 if cone_rows is None else cone_rows.numel(),
        ptr(x.data_ptr()), ptr(y.data_ptr()),
        ptr(x_sum.data_ptr()), ptr(y_sum.data_ptr()),
        ptr(xo.data_ptr()), ptr(yo.data_ptr()),
        ptr(xso.data_ptr()), ptr(yso.data_ptr()),
        *draws, ptr(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{rc}")
    run_window.launches[kernel] += 1
    return xo, yo, xso, yso


run_window.launches = {"pdhg_window": 0, "pdhg_window_soc": 0,
                       "pdhg_window_synth": 0}
