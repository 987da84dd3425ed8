###############################################################################
# The PDHG restart window: n_iters PDHG iterations per scenario against a
# shared dense A, as hand-written CUDA kernels (csrc/) with their plain
# PyTorch version beside them.
#
# Replaces mpisppy_tpu/ops/pdhg_pallas.py::run_window — the Pallas TPU
# kernel (_tile_math, run through either the single-buffer grid kernel or
# the double-buffered pipeline; both compute the same function, so one
# CUDA kernel ports both), box rows and the SOC dual prox
# (_tile_math.soc_prox) alike.  Three instantiations, counted apart in
# run_window.launches: "pdhg_window" (box rows only), "pdhg_window_soc"
# (a batch with second-order-cone blocks) and "pdhg_window_synth" (box
# rows whose drawn bound rows the kernel synthesizes itself from threefry
# keys: run_window(synth=TileSynth), the port of the Pallas engine's
# in-kernel tile synthesis).
#
# Three designs compute the same function; plan_window, a pure function
# of the mode, the shape and the card's limits, picks one per launch:
# - resident: persistent blocks copy A into shared memory once per launch
#   and walk tiles of scenarios.  Box and synth batches whose A fits
#   resident_layout run csrc/pdhg_window_resident.cu (A packed by
#   pack_resident, tiles of 8 scenarios whose state stays in registers;
#   bf16 and bf16x3 products on tensor cores, f32 on CUDA cores); SOC
#   batches whose layout fits cone_layout run csrc/pdhg_window_cones.cu
#   (A packed by pack_cones, tiles of 8, 16 or 24 scenarios whose state
#   stays in shared memory, every product on CUDA cores).
# - streamed (csrc/pdhg_window.cu): A read from L2 twice per iteration,
#   one or four scenarios per block with their state in shared memory.
#   It takes any A too large for the resident layouts, at batches that
#   fill the card.
# - split (csrc/pdhg_window_split.cu): one problem's columns and rows cut
#   into P slabs over P blocks of one cooperative launch (split_columns,
#   split_rows), A's column slab in shared memory where it fits, two grid
#   barriers an iteration.  It takes the small batches of those shapes
#   (an EF, an L-shaped master: one problem), which the streamed design
#   ran on one SM each.
# run_window.launches_by_design counts each launch under
# "<instantiation>/<mode>/<design>".
#
# Rule: run_window takes the plain version only for CPU tensors.  For
# CUDA tensors it launches the planned design or raises — there is no
# fallback and no retry on the other design.  The kernels are compiled
# with nvcc for sm_90a at first use into mpisppy_tpu_torch/_build/ and
# loaded with ctypes.
###############################################################################
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from mpisppy_tpu_torch.dispatch import compilewatch
from mpisppy_tpu_torch.ops import cones as cones_mod
from mpisppy_tpu_torch.ops.boxqp import BoxQP, as_precision

Tensor = torch.Tensor

_BIG = 1e30  # finite stand-in for +-inf row bounds (0 * inf would be NaN)
_MODES = {"f32": 0, "bf16": 1, "bf16x3": 3}

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "pdhg_window.cu", CSRC / "pdhg_window_resident.cu",
           CSRC / "pdhg_window_cones.cu", CSRC / "pdhg_window_split.cu")
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libpdhg_window.so"
BUILD_LOG = BUILD_DIR / "pdhg_window.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    blocks.  An ELL matrix is never in it, shared or not."""
    return isinstance(p.A, torch.Tensor) and p.A.ndim == 2 \
        and p.c.ndim == 2


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


# -- the work model ------------------------------------------------------
# The least work of one window, for its least-time bound (chip_smoke.py's
# bound column) and for the roofline of a profile (telemetry/roofline.py
# reads it from the record_function range run_window opens around each
# launch while a profiler runs).

#: threefry2x32 operations per draw: 20 rounds of add, rotate (two
#: shifts and an or) and xor, the key injections, and the bits-to-float
#: and compare — integer work counted at the f32 CUDA-core rate
THREEFRY_OPS = 125


def stored_bytes(t: Tensor) -> int:
    """Bytes an input holds: a stride-0 (S, k) view (a shared row
    expanded over the batch) is read as its one row."""
    if t.ndim == 2 and t.stride(0) == 0:
        t = t[0]
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class WindowWork:
    """The bytes a window must move (each input read once, each output
    written once) and its operations by the peak they run at: "bf16"
    the tensor cores' products in bf16x3 mode, "f32" the rest."""

    S: int
    m: int
    n: int
    iters: int
    nbytes: int
    f32_flops: float
    bf16_flops: float

    def label(self, key: str) -> str:
        """The record_function range name of a launch
        (telemetry/deviceprof.py::WORK_RE)."""
        return (f"{key}[S={self.S} m={self.m} n={self.n} it={self.iters} "
                f"bytes={self.nbytes} f32_flops={self.f32_flops:.0f} "
                f"bf16_flops={self.bf16_flops:.0f}]")

    def bound_ms(self, peaks: dict) -> tuple[float, str]:
        """Least time on a card with these peak rates
        (telemetry/roofline.py::CARD_PEAKS), in ms, and what binds it:
        "bytes" or "operations"."""
        from mpisppy_tpu_torch.telemetry import roofline
        t, by = roofline.least_time_s(
            self.nbytes, {"f32": self.f32_flops, "bf16": self.bf16_flops},
            peaks)
        return 1e3 * t, by


def window_work(p: BoxQP, x: Tensor, y: Tensor, x_sum: Tensor,
                y_sum: Tensor, tau: Tensor, sigma: Tensor, done: Tensor,
                n_iters: int, precision=None,
                synth: TileSynth | None = None) -> WindowWork:
    """The work of run_window on these operands: A'y and A v are 4 m n
    flops per scenario and iteration, the prox, clips and window sums
    9 n + 6 m; SOC rows add about 6 flops each per iteration (shift,
    square, sum, scale, subtract, window sum) and each block a sqrt and
    a divide.  With `synth` the drawn rows are not read: bl/bu are the
    shared template rows, d_row is read once, and each scenario pays one
    key fold and one draw per drawn row (THREEFRY_OPS each).  In bf16x3
    mode the products run three times on the tensor cores; in f32 and
    bf16 they count at the f32 rate."""
    mode = as_precision(precision) or "f32"
    S, n = x.shape
    m = y.shape[1]
    ins = [p.A, p.c, p.q, p.l, p.u, p.bl, p.bu, x, y, x_sum, y_sum, tau,
           sigma, done]
    soc_rows = 0
    if p.cones is not None:
        cone_ptr, cone_rows = p.cones.csr(x.device)
        ins += [cone_ptr, cone_rows]
        soc_rows = cone_rows.numel()
    if synth is not None:
        ins.append(synth.d_row)
    nbytes = sum(stored_bytes(t) for t in ins) \
        + 2 * (x.numel() + y.numel()) * 4
    mac_flops = 4.0 * m * n * S * n_iters
    elem_flops = (9.0 * n + 6.0 * m) * S * n_iters
    if synth is not None:
        elem_flops += THREEFRY_OPS * (1 + synth.draws.count) * S
    if p.cones is not None:
        elem_flops += (6.0 * soc_rows + 2.0 * p.cones.num_cones) * S \
            * n_iters
    if mode == "bf16x3":
        return WindowWork(S, m, n, int(n_iters), nbytes, elem_flops,
                          3 * mac_flops)
    return WindowWork(S, m, n, int(n_iters), nbytes,
                      mac_flops + elem_flops, 0.0)


def _build_inputs() -> list[Path]:
    """Every file under csrc/ that goes into the library: the sources
    and the headers they include."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _stale() -> bool:
    """True when the library is missing or older than any build input."""
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(p.stat().st_mtime > built for p in _build_inputs())


def _library():
    """Build (at first use, when missing or older than any file under
    csrc/) and load the kernels' shared library."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    if _stale():
        build()
    lib = ctypes.CDLL(str(LIBRARY))
    # the first build/load is this process's "compile" of the kernels
    compilewatch.record(time.perf_counter() - t0)
    fn = lib.pdhg_window_launch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    U, F = ctypes.c_uint, ctypes.c_float
    fn.argtypes = ([I, I, I, P, L]
                   + [P, P, I, I, I, I, I, P, P, P] + [P, L] * 6
                   + [P, P, I, I] + [P] * 8
                   + [U, U, I, I, I, I, F, F, F, I, I, P]
                   + [I, P, P, P, P])
    fn.restype = I
    lib.pdhg_window_limits.argtypes = [ctypes.POINTER(I)] * 2
    lib.pdhg_window_limits.restype = I
    lib.pdhg_window_resident_bytes.argtypes = [I, I, I, I]
    lib.pdhg_window_resident_bytes.restype = L
    lib.pdhg_window_cones_bytes.argtypes = [I, I, I, I, I, I]
    lib.pdhg_window_cones_bytes.restype = L
    lib.pdhg_window_split_bytes.argtypes = [I] * 6
    lib.pdhg_window_split_bytes.restype = L
    _lib = lib
    return lib


def build() -> str:
    """Compile the csrc/ sources with nvcc for sm_90a, one nvcc per
    source, all started together, and link them into one library in
    BUILD_DIR.  Returns the compiler's output (ptxas register, spill and
    shared-memory lines of every kernel)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
             str(src)] for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log = ""
    for cmd, proc in zip(cmds, procs):
        log += " ".join(cmd) + "\n" + proc.communicate()[0]
    failed = any(proc.returncode != 0 for proc in procs)
    if not failed:
        tmp = BUILD_DIR / f".libpdhg_window.{tag}.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + res.stdout + res.stderr
        failed = res.returncode != 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    BUILD_LOG.write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed building {CSRC}:\n{log}")
    os.replace(tmp, LIBRARY)
    return log


@functools.lru_cache(maxsize=None)
def card_limits(device_index: int) -> tuple[int, int]:
    """(opt-in shared memory per block in bytes, SM count) of the CUDA
    device (the current one when the library asks), as the shape rule
    reads them."""
    I = ctypes.c_int
    smem, sms = I(0), I(0)
    rc = _library().pdhg_window_limits(ctypes.byref(smem), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"pdhg_window_limits failed: CUDA error {rc}")
    return smem.value, sms.value


# ---- the resident design's layout and the shape rule (pure) ----------------

RESIDENT_TILE = 8          # scenarios per tile: the n8 of mma.m16n8k16
RESIDENT_MAX_M = 64        # the dual step: 2 (row, scenario) pairs a thread
RESIDENT_MAX_N = 768       # 8 warps x 6 column tiles of 16 = 256 threads x 3
_PARTIAL_STRIDE = 68       # floats per scenario row of the A v partial sums
_STATIC_SMEM = 1024        # headroom for the kernels' static shared memory
CONE_TILES = (8, 16, 24)   # cone design: 1-3 groups of 8 scenarios a task
CONE_PARTS = 3             # its dots split in 3 at tile 8
_CONE_BLOCKS_PER_SM = 2    # its __launch_bounds__(256, 2)
_SMEM_RESERVED = 1024      # shared memory the card keeps per block: an
                           # SM's is the opt-in per-block limit + this


def _round_up(v: int, k: int) -> int:
    return -(-v // k) * k


@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    """Shared-memory layout of the resident design for one (mode, m, n);
    csrc/pdhg_window_resident.cu::make_layout computes the same numbers.
    f32: A as (m, a_stride) f32 with an odd row stride; bf16/bf16x3: A as
    1 or 2 bf16 planes (hi, lo) of (m_pad, a_stride), m and n padded to
    16 and the row stride n_pad + 8.  image_bytes is the packed A,
    smem_bytes the whole dynamic shared memory of a block."""

    mode: str
    m: int
    n: int
    m_pad: int
    n_pad: int
    a_stride: int
    planes: int
    image_bytes: int
    smem_bytes: int


def resident_layout(mode: str, m: int, n: int) -> ResidentLayout | None:
    """The resident layout of (mode, m, n), or None outside its limits
    (m <= 64, n <= 768)."""
    if not (0 < m <= RESIDENT_MAX_M and 0 < n <= RESIDENT_MAX_N):
        return None
    T = RESIDENT_TILE
    if mode == "f32":
        m_pad, n_pad, stride, planes = m, n, n | 1, 1
        image = _round_up(m * stride * 4, 16)
        v_bytes, y_bytes = n * T * 4, m * T * 4
        kq = 8
    else:
        planes = 2 if mode == "bf16x3" else 1
        m_pad, n_pad = _round_up(m, 16), _round_up(n, 16)
        stride = n_pad + 8
        image = planes * m_pad * stride * 2
        v_bytes = planes * T * stride * 2
        y_bytes = planes * T * (m_pad + 8) * 2
        kq = 8 // (m_pad // 16)
    smem = (image + _round_up(v_bytes, 16) + _round_up(y_bytes, 16)
            + kq * T * _PARTIAL_STRIDE * 4)
    return ResidentLayout(mode, m, n, m_pad, n_pad, stride, planes, image,
                          smem)


def pack_resident(A: Tensor, layout: ResidentLayout) -> Tensor:
    """A (m, n) f32 as the resident kernel's shared-memory image, zero
    padded: f32 rows of a_stride, or the bf16 hi (and lo) planes of
    _split_bf16.  The kernel copies it byte for byte."""
    L = layout
    if L.mode == "f32":
        img = torch.zeros(L.image_bytes // 4, dtype=torch.float32,
                          device=A.device)
        img[:L.m * L.a_stride].view(L.m, L.a_stride)[:, :L.n] = A
        return img
    img = torch.zeros((L.planes, L.m_pad, L.a_stride), dtype=torch.bfloat16,
                      device=A.device)
    hi, lo = _split_bf16(A)
    img[0, :L.m, :L.n] = hi
    if L.planes == 2:
        img[1, :L.m, :L.n] = lo
    return img


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """Shared-memory layout of the resident design for SOC batches at
    (mode, m, n, tile, cone_ints); csrc/pdhg_window_cones.cu::make_layout
    computes the same numbers.  A as 1 plane (f32 values of A, or of its
    bf16 hi part) or 2 (bf16x3: hi and lo) of (m, a_stride = n | 1) f32,
    then n_vecs n-vectors and m_vecs m-vectors per scenario of the tile,
    then the partial sums of the dots split in CONE_PARTS (tile 8 only),
    then the cone layout's ints.  image_bytes is the packed A, smem_bytes
    the whole dynamic shared memory of a block."""

    mode: str
    m: int
    n: int
    tile: int
    a_stride: int
    planes: int
    n_vecs: int
    m_vecs: int
    image_bytes: int
    smem_bytes: int


def cone_layout(mode: str, m: int, n: int, tile: int,
                cone_ints: int) -> ConeLayout | None:
    """The cone layout of (mode, m, n) at `tile` scenarios per tile
    (CONE_TILES), or None outside it.  n-vectors: x, its window sum,
    tau*c, 1/(1 + tau*q), l, u, v (v's lo too in bf16x3); m-vectors: y,
    its window sum, sigma*bl, sigma*bu, w (y's bf16 hi, and lo in bf16x3,
    in the bf16 modes)."""
    if tile not in CONE_TILES or m <= 0 or n <= 0 or cone_ints <= 0:
        return None
    planes = 2 if mode == "bf16x3" else 1
    stride = n | 1
    image = 4 * _round_up(planes * m * stride, 4)
    n_vecs = 6 + planes
    m_vecs = 5 + {"f32": 0, "bf16": 1, "bf16x3": 2}[mode]
    parts = CONE_PARTS * tile * max(m, n) if tile == 8 else 0
    smem = (image + 4 * tile * (n_vecs * n + m_vecs * m) + 4 * parts
            + 4 * cone_ints)
    return ConeLayout(mode, m, n, tile, stride, planes, n_vecs, m_vecs,
                      image, smem)


def pack_cones(A: Tensor, layout: ConeLayout) -> Tensor:
    """A (m, n) f32 as the cone kernel's shared-memory image, zero padded:
    rows of a_stride f32 values of A (f32), of its bf16 hi part (bf16),
    or the hi plane then the lo plane (bf16x3)."""
    L = layout
    img = torch.zeros(L.image_bytes // 4, dtype=torch.float32,
                      device=A.device)
    planes = (A,) if L.mode == "f32" else _split_bf16(A)[:L.planes]
    size = L.m * L.a_stride
    for k, plane in enumerate(planes):
        img[k * size:(k + 1) * size].view(L.m, L.a_stride)[:, :L.n] = plane
    return img


def _plan_cones(mode: str, m: int, n: int, S: int, smem_per_block: int,
                sm_count: int, cone_ints: int) -> "WindowPlan | None":
    """The cone design's tile and grid, or None when no tile's layout
    fits the card: the fewest rounds of tiles over the card's block slots
    (blocks an SM holds, by shared memory and the kernel's launch bounds,
    times the SMs), then the smallest tile, whose dots are split over
    more threads.  At ccopf's shape: 24 at S=10,000, 8 at S=64, the
    fastest tile in f32 at both on an H100 (tools/soc_tile_sweep.py)."""
    best = None
    for tile in CONE_TILES:
        L = cone_layout(mode, m, n, tile, cone_ints)
        if L is None or L.smem_bytes + _STATIC_SMEM > smem_per_block:
            continue
        per_sm = min(_CONE_BLOCKS_PER_SM,
                     (smem_per_block + _SMEM_RESERVED)
                     // (L.smem_bytes + _STATIC_SMEM + _SMEM_RESERVED))
        slots = per_sm * sm_count
        tiles = -(-S // tile)
        rounds = -(-tiles // slots)
        if best is None or rounds < best[0]:
            best = (rounds, WindowPlan("resident", tile,
                                       max(1, min(tiles, slots))))
    return None if best is None else best[1]


def streamed_smem_bytes(m: int, n: int, spb: int, cone_ints: int = 0) -> int:
    """Dynamic shared memory of a streamed block of spb scenarios (eight
    n-vectors and six m-vectors each, a seventh with cones, plus the
    cone layout's ints; csrc/pdhg_window.cu::smem_bytes)."""
    per = 8 * n + (7 if cone_ints else 6) * m
    return 4 * spb * per + 4 * cone_ints


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    design: str    # "resident", "streamed" or "split"
    tile: int      # scenarios per tile (resident) or per block (streamed),
                   # blocks per problem (split: P)
    blocks: int    # blocks launched
    a_smem: bool = False  # split: A's column slab held in shared memory


def _resident_plan(mode: str, m: int, n: int, S: int, smem_per_block: int,
                   sm_count: int, cone_ints: int) -> WindowPlan | None:
    """The resident design's plan for the shape, or None where its
    layout does not fit the block's shared memory at any tile."""
    if cone_ints:
        return _plan_cones(mode, m, n, S, smem_per_block, sm_count,
                           cone_ints)
    L = resident_layout(mode, m, n)
    if L is None or L.smem_bytes + _STATIC_SMEM > smem_per_block:
        return None
    tiles = -(-S // RESIDENT_TILE)
    return WindowPlan("resident", RESIDENT_TILE, max(1, min(tiles, sm_count)))


def streamed_fits(m: int, n: int, smem_per_block: int,
                  cone_ints: int = 0) -> bool:
    """Whether one streamed scenario's vectors fit a block's shared
    memory (the streamed design takes every shape that passes)."""
    return streamed_smem_bytes(m, n, 1, cone_ints) <= smem_per_block


# ---- the split design: one problem over P blocks (pure) ---------------------

SPLIT_THREADS = 256        # csrc/pdhg_window_common.cuh kSplitThreads
SPLIT_BLOCKS_PER_SM = 2    # blocks of the grid an SM holds at most (the
                           # kernel's __launch_bounds__(256, 2))
SPLIT_MIN_COLS = 8         # columns a block takes at least
SPLIT_MIN_SMS = 4          # SMs a problem gets at least: S <= 33 on an H100


def split_columns(n: int, P: int) -> list[tuple[int, int]]:
    """Block b's column slab [b*n//P, (b+1)*n//P): the formula the kernel
    computes (ragged; empty slabs when P > n)."""
    return [(b * n // P, (b + 1) * n // P) for b in range(P)]


def split_rows(m: int, P: int, cone_ptr=None, cone_rows=None):
    """The row partition of the split design as the kernel reads it with
    SOC blocks: one int32 array [row_ptr (P+1) | box_cnt (P) | cone_ptr
    (P+1) | rows (m) | cones (C)].  Block b owns rows[row_ptr[b]:
    row_ptr[b+1]], its box rows first (box_cnt[b] of them), then the rows
    of its SOC blocks cones[cone_ptr[b]:cone_ptr[b+1]] (whole cones, head
    first).  Units (a box row, or a whole cone) are taken in order of
    their first row and a unit goes to the block whose share
    [b*m//P, (b+1)*m//P) of the running row count holds its start, so
    without cones block b owns [b*m//P, (b+1)*m//P), the kernel's own
    formula for box rows."""
    import numpy as np
    bounds = np.array([b * m // P for b in range(P + 1)])
    units = []                      # (first row, rows, cone or -1)
    is_soc = np.zeros(m, bool)
    if cone_ptr is not None:
        ptr = np.asarray(cone_ptr, dtype=np.int64)
        rws = np.asarray(cone_rows, dtype=np.int64)
        for k in range(len(ptr) - 1):
            r = rws[ptr[k]:ptr[k + 1]]
            is_soc[r] = True
            units.append((int(r.min()), r, k))
    units += [(i, np.array([i]), -1) for i in np.flatnonzero(~is_soc)]
    units.sort(key=lambda u: u[0])
    box = [[] for _ in range(P)]
    soc = [[] for _ in range(P)]
    cones = [[] for _ in range(P)]
    start = 0
    for _, r, k in units:
        b = int(np.searchsorted(bounds, start, side="right")) - 1
        if k < 0:
            box[b].append(int(r[0]))
        else:
            soc[b].extend(int(v) for v in r)
            cones[b].append(k)
        start += len(r)
    rows = [box[b] + soc[b] for b in range(P)]
    row_ptr = np.cumsum([0] + [len(r) for r in rows])
    cone_blk = np.cumsum([0] + [len(c) for c in cones])
    flat = lambda parts: [v for part in parts for v in part]  # noqa: E731
    return np.concatenate([row_ptr, [len(v) for v in box], cone_blk,
                           flat(rows), flat(cones)]).astype(np.int32)


def split_smem_bytes(mode: str, m: int, n: int, P: int, cones: bool,
                     a_smem: bool) -> int:
    """Dynamic shared memory of a split block (csrc/pdhg_window_common.cuh
    ::split_smem_bytes): A's widest column slab (W = ceil(n / P) columns,
    row stride W | 1: f32 values, or the bf16 hi (and lo) planes) when
    a_smem, eight n-vectors of W, four m-vectors, two more in the bf16
    modes and one with cones, and SPLIT_THREADS partial sums."""
    W = -(-n // P)
    elem, planes = (4, 1) if mode == "f32" else \
        (2, 2 if mode == "bf16x3" else 1)
    slab = _round_up(planes * m * (W | 1) * elem, 16) if a_smem else 0
    mvecs = 4 + (0 if mode == "f32" else 2) + (1 if cones else 0)
    return slab + 4 * (8 * W + mvecs * m + SPLIT_THREADS)


def _split_plan(mode: str, m: int, n: int, S: int, smem_per_block: int,
                sm_count: int, cones: bool) -> WindowPlan | None:
    """The split design's plan, or None where it cannot run.  P = the
    blocks an SM holds (SPLIT_BLOCKS_PER_SM where their shared memory
    fits the SM's, else fewer) times the SMs, divided by S, and at most
    n // SPLIT_MIN_COLS; A's slab in shared memory where it fits, else
    read from L2.  None when S exceeds the blocks the card holds at once
    or a block's vectors alone pass its shared memory.  The launch checks
    the grid against the occupancy API and raises past it."""
    if S <= 0:
        return None
    for per_sm in range(SPLIT_BLOCKS_PER_SM, 0, -1):
        P = min(per_sm * sm_count // S, max(1, n // SPLIT_MIN_COLS))
        if P < 1:
            continue
        for a_smem in (True, False):
            need = split_smem_bytes(mode, m, n, P, cones, a_smem) \
                + _STATIC_SMEM
            if need <= smem_per_block and per_sm * (need + _SMEM_RESERVED) \
                    <= smem_per_block + _SMEM_RESERVED:
                return WindowPlan("split", P, S * P, a_smem)
    return None


def design_fits(mode: str, m: int, n: int, S: int, smem_per_block: int,
                sm_count: int, cone_ints: int = 0) -> bool:
    """Whether some window design takes the shape: the condition under
    which plan_window, with no design named, returns a plan."""
    return _resident_plan(mode, m, n, S, smem_per_block, sm_count,
                          cone_ints) is not None \
        or streamed_fits(m, n, smem_per_block, cone_ints) \
        or _split_plan(mode, m, n, S, smem_per_block, sm_count,
                       cone_ints > 0) is not None


def plan_window(mode: str, m: int, n: int, S: int, smem_per_block: int,
                sm_count: int, cone_ints: int = 0,
                design: str | None = None,
                synth: bool = False) -> WindowPlan:
    """The shape rule: which design runs a window.  The resident design
    takes every box or synth batch (cone_ints == 0) whose layout fits
    the card's shared memory per block, at any S, in min(tiles, SMs)
    persistent blocks: on an H100 it beat the streamed design at every
    shape timed, down to the fused wheel's straggler tail (S=64, 160
    iterations, 8 of 132 SMs busy; chip_smoke.py [window_time]).  It
    takes every SOC batch (cone_ints > 0: the CSR offsets, rows and a
    flag per row) whose cone layout fits at some tile, with the tile and
    grid of _plan_cones.  Of the rest, the split design (not with
    in-kernel synthesis: `synth`) takes a batch of S <= SMs /
    SPLIT_MIN_SMS problems (33 on an H100), with the P of _split_plan,
    and any batch it can run that the streamed design cannot take (the
    735 x 7,050 sampled EF); the streamed design takes the rest, four
    scenarios per block once S >= 8 x SMs and four fit, else one.
    On an H100 80GB HBM3 at 700 W (chip_smoke.py [window_time_split],
    f32, 40 iterations) the split window took 0.45-0.47 ms against 37.8
    streamed on the 660 x 6,345 EF at S=1, 0.21-0.43 ms against 0.49-
    10.4 on the other one-problem shapes, and on that EF 1.7, 3.6, 6.9,
    13.6 and 26.9 ms against 37.3-39.4 at S=2, 4, 8, 16 and 33 (A read
    from L2), but 50.8 against 39.6-42.8 at S=66 and 135.6 against 40.4
    at S=100; the cross-scenario view (820 x 85, S=100) took 1.86 against
    3.53 and stays streamed with the rest.  Its P: two blocks an SM and
    at least 8 columns a block were the fastest of the sweep of
    chip_smoke.py's SPLIT_SWEEP, or within 0.02 ms of it, at every
    one-problem shape (0.45 against 0.47 ms for P=264 against 132 on
    the EF; 0.21 against 0.25 for P=30 against 132 at 197 x 240), and
    3.6 against 5.9 ms and 13.6 against 22.6 at S=4 and 16.
    `design` names the design instead of the rule (to time them on one
    batch); naming one for a batch it cannot take raises, and so does a
    shape no design takes."""
    resident = _resident_plan(mode, m, n, S, smem_per_block, sm_count,
                              cone_ints)
    split = None if synth else _split_plan(mode, m, n, S, smem_per_block,
                                           sm_count, cone_ints > 0)
    streamed = streamed_fits(m, n, smem_per_block, cone_ints)
    if design is None:
        if resident is not None:
            design = "resident"
        elif split is not None and (not streamed
                                    or S * SPLIT_MIN_SMS <= sm_count):
            design = "split"
        else:
            design = "streamed"
    if design == "resident":
        if resident is None:
            raise ValueError(f"the resident design cannot take a {mode} "
                             f"window of shape ({m}, {n}) with cones="
                             f"{cone_ints > 0}")
        return resident
    if design == "split":
        if split is None:
            raise ValueError(f"the split design cannot take a {mode} "
                             f"window of shape ({m}, {n}) at S={S} with "
                             f"cones={cone_ints > 0}, synth={synth}")
        return split
    if design != "streamed":
        raise ValueError(f"unknown window design {design!r}")
    if not streamed:
        raise ValueError(f"no window design takes shape ({m}, {n}) at "
                         f"S={S} with cones={cone_ints > 0}: one streamed "
                         "scenario needs more shared memory than a block "
                         "has, and the split design cannot run it")
    spb = 4 if (S >= 8 * sm_count and streamed_smem_bytes(
        m, n, 4, cone_ints) <= smem_per_block) else 1
    return WindowPlan("streamed", spb, max(1, -(-S // spb)))


def cone_ints_of(p: BoxQP, device) -> int:
    """The cone layout's ints of `p` (the CSR offsets, rows and a flag
    per row; 0 without cones), as the shape rule counts them."""
    spec = p.cones
    if spec is None or spec.num_cones == 0:
        return 0
    nnz = int(spec.csr(device)[1].numel())
    return spec.num_cones + 1 + nnz + p.A.shape[0]


def takes(p: BoxQP, precision=None) -> bool:
    """Whether a window design takes the batch `p` on its device:
    always on the CPU (the plain version runs any shape); on CUDA,
    design_fits for its shape on this card."""
    if not supported(p):
        return False
    if p.c.device.type != "cuda":
        return True
    m, n = p.A.shape
    return design_fits(as_precision(precision) or "f32", m, n, p.c.shape[0],
                       *card_limits(p.c.device.index),
                       cone_ints=cone_ints_of(p, p.c.device))


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
               synth: TileSynth | None = None, design: str | None = None):
    """n_iters PDHG iterations over the whole scenario batch.  Returns
    (x, y, x_sum, y_sum).  Shapes: x,c,q (S, n); y (S, m); tau/sigma/done
    (S,); A (m, n) shared; l/u/bl/bu shared or per-scenario (a stride-0
    (S, k) view counts as shared).  `synth` (box rows only): the kernel
    draws the TileSynth's rows itself (scengen.window_inputs builds
    both p and synth from a VirtualBatch).  `design` ("resident",
    "streamed" or "split") overrides the shape rule, to time the designs
    on one batch; None lets plan_window decide.

    CPU tensors take the plain version; CUDA tensors launch the planned
    kernel (counted in run_window.launches under the instantiation's name
    and in run_window.launches_by_design) or raise."""
    _check_synth(p, synth)
    if x.device.type == "cpu":
        return run_window_reference(p, x, y, x_sum, y_sum, tau, sigma,
                                    done, n_iters, precision, synth)
    if x.device.type != "cuda":
        raise ValueError(f"run_window: unsupported device {x.device}")
    if not supported(p):
        raise NotImplementedError(
            "the CUDA window kernel takes a batched problem with one dense "
            "shared A (pdhg.window_engine sends other problems to the "
            "plain iteration)")
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
        num_cones, cone_nnz = spec.num_cones, cone_rows.numel()
        kernel = "pdhg_window_soc"
    else:
        cone_ptr = cone_rows = None
        num_cones = cone_nnz = 0
        kernel = "pdhg_window"
    done_f = done.to(torch.float32).contiguous()
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
    cone_ints = cone_ints_of(p, x.device)
    plan = plan_window(mode, m, n, S, *card_limits(x.device.index),
                       cone_ints=cone_ints, design=design,
                       synth=synth is not None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    A_main = A_lo = img = part = layout = bar = None
    if plan.design == "split":
        part = torch.empty(S * plan.tile * m, dtype=torch.float32,
                           device=x.device)
        bar = _grid_barrier(x.device, stream)
        if num_cones:
            layout = _split_layout(spec, m, plan.tile, x.device)
    if plan.design == "resident" and num_cones:
        img = pack_cones(p.A, cone_layout(mode, m, n, plan.tile, cone_ints))
    elif plan.design == "resident":
        img = pack_resident(p.A, resident_layout(mode, m, n))
    elif mode == "f32":
        A_main = p.A
    else:
        A_main, A_lo = _split_bf16(p.A)
        if mode == "bf16":
            A_lo = None
    ptr = ctypes.c_void_p

    def addr(t):
        return ptr(0 if t is None else t.data_ptr())

    key = f"{kernel}/{mode}/{plan.design}"
    # under a profiler the launch sits in a range named by its work, the
    # roofline's bytes and flops for this kernel (deviceprof.WORK_RE)
    rng = torch.profiler.record_function(window_work(
        p, x, y, x_sum, y_sum, tau, sigma, done, n_iters, mode,
        synth).label(key)) if torch.autograd._profiler_enabled() \
        else contextlib.nullcontext()
    with rng:
        rc = lib.pdhg_window_launch(
            _DESIGNS[plan.design], plan.tile, plan.blocks, addr(img),
            0 if img is None else img.numel() * img.element_size(),
            addr(A_main), addr(A_lo), m, n, S, int(n_iters), _MODES[mode],
            addr(tau), addr(sigma), addr(done_f),
            addr(p.c), _stride(p.c, S), addr(p.q), _stride(p.q, S),
            addr(p.l), _stride(p.l, S), addr(p.u), _stride(p.u, S),
            addr(p.bl), _stride(p.bl, S), addr(p.bu), _stride(p.bu, S),
            addr(cone_ptr), addr(cone_rows), num_cones, cone_nnz,
            addr(x), addr(y), addr(x_sum), addr(y_sum),
            addr(xo), addr(yo), addr(xso), addr(yso),
            *draws, int(plan.a_smem), addr(part), addr(bar), addr(layout),
            ptr(stream))
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed ({plan.design} "
                           f"design): CUDA error {rc}")
    run_window.launches[kernel] += 1
    counts = run_window.launches_by_design
    counts[key] = counts.get(key, 0) + 1
    return xo, yo, xso, yso


_DESIGNS = {"streamed": 0, "resident": 1, "split": 2}
_BARRIERS: dict = {}


def _grid_barrier(device, stream: int) -> Tensor:
    """The split kernel's two barrier words (arrive count, blocks
    finished) for launches on `stream`: zeroed once and left at 0 by
    every launch that ends, so launches in stream order share them."""
    key = (device.index, stream)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _BARRIERS[key]


def _split_layout(spec, m: int, P: int, device) -> Tensor:
    """split_rows of the cone spec at P blocks on `device`, built once
    per (P, device) and cached on the spec beside its CSR."""
    key = f"split/{P}/{torch.device(device)}"
    if key not in spec._csr:
        cone_ptr, cone_rows = spec.csr("cpu")
        spec._csr[key] = torch.as_tensor(
            split_rows(m, P, cone_ptr.numpy(), cone_rows.numpy()),
            device=device)
    return spec._csr[key]


run_window.launches = {"pdhg_window": 0, "pdhg_window_soc": 0,
                       "pdhg_window_synth": 0}
run_window.launches_by_design = {}
