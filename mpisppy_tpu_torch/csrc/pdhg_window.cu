// PDHG restart window for a batch of LPs/QPs sharing one dense
// constraint matrix A (m x n): n_iters iterations per scenario of
//
//     x1 = clip((x - tau*A'y - tau*c) * 1/(1 + tau*q), l, u)
//     w  = y + sigma*A(2*x1 - x)
//     y1 = w - clip(w, sigma*bl, sigma*bu)        (box rows)
//     y1 = Proj_polar(w - sigma*b)                 (SOC rows, b = bl = bu)
//     xs += x1;  ys += y1
//
// with done scenarios frozen: they run with tau = sigma = 0 and keep
// their iterates bit for bit (even an iterate one rounding outside its
// box), while their window sums keep accumulating.  Infinite row bounds
// are clipped to +-1e30 first, so sigma = 0 never meets inf.
//
// Replaces mpisppy_tpu/ops/pdhg_pallas.py::run_window (_tile_math, both
// the single-buffer grid kernel and the double-buffered pipeline, which
// compute the same function; the double buffering was a TPU data-movement
// device), including the SOC dual prox (_tile_math.soc_prox).
//
// This file holds the streamed design (and the entry of all four): A
// stays in L2 and is read twice
// per iteration (A'y and A v, 4*m*n flops), and each block keeps SPB
// scenarios' state (~24 KB each at the sslp 15x45 shape, A 60 x 705) in
// shared memory for the whole window, so each element of A read from L2
// feeds SPB multiply-adds.  It takes the batches the resident designs
// (A in shared memory once per launch: pdhg_window_resident.cu for box
// rows, products on tensor cores; pdhg_window_cones.cu for SOC blocks)
// do not: an A or tile too large for their layouts, such as the 33-bus
// feeder's, at batches large enough to fill the card; smaller batches
// of such shapes take the split design (pdhg_window_split.cu: one
// problem over many blocks); ops/pdhg_window.py::plan_window decides.
//
// Second-order-cone rows (template flag CONES; the box-only
// instantiation compiles to the code it had without them).  The blocks
// arrive as CSR, cone_ptr (C+1) and cone_rows (head first, any row
// order), staged once per thread block in shared memory.  The dual step
// leaves w on SOC rows in shared memory; after a barrier one thread per
// (scenario, block) forms wsh = w - sigma*b, the head t and ||z|| (sum of
// squares, then sqrtf), and writes the polar projection back
// (soc_block, pdhg_window_common.cuh, shared with the resident design):
//     ||z|| <= t   -> y1 = 0
//     ||z|| <= -t  -> y1 = wsh
//     otherwise    -> alpha = (t + ||z||)/2,  y1 = wsh - (alpha,
//                     z*alpha/max(||z||, 1e-30))
// All of it in IEEE f32 in every mode (the Pallas kernel ran it as
// HIGHEST-precision dots); products and sums go through __fmul_rn /
// __fadd_rn so no FMA contraction changes their rounding.  Frozen lanes
// keep y bit for bit here too: tau = sigma = 0 does not make the cone
// branch a no-op (Proj_polar(y) != y in general).  The Pallas kernel's
// 0/1 membership-matrix dots were a way around Mosaic having no scatter
// and are not carried over.
//
// In-kernel scenario synthesis (template flag SYNTH, box rows only;
// "pdhg_window_synth" in ops/pdhg_window.py).  Replaces the Pallas
// engine's TileSynth (mpisppy_tpu/ops/pdhg_pallas.py:279-314, called
// in-kernel at :624-629) with the draws that
// mpisppy_tpu/scengen/tiles.py:36-113 built from the model's sampler.
// A CUDA kernel cannot run a Python sampler, so the program states its
// rule as data (scengen.RowDraws) and only the load phase changes: for
// scenario sc the block takes the program index idx = min(sc,
// num_real - 1) + start and the key threefry2x32(base_key, (0, idx))
// (jax.random.fold_in), and for every drawn row j of [row0, row0 + count)
//     bits = y0 ^ y1 of threefry2x32(key, (0, j))
//     u    = __uint_as_float((bits >> 9) | 0x3F800000) - 1      (uniform)
//     v    = u < threshold ? below : above
//     bl/bu[row0 + j] = clip(__fmul_rn(v, d_row[row0 + j]), +-1e30)
// before sigma scales it, as for a loaded row.  Rows that are not drawn
// read the shared scaled template (stride 0).  The bits are jax.random's
// (partitionable threefry layout), and the product is one IEEE rounding
// as in VirtualBatch.realize, so a synthesized window equals the box
// kernel's window on the realized batch bit for bit.  The key comes from
// the wrapper's arguments, never from a generator of the kernel's own.
// What bounds it: the iterations, not the draws — one 40-iteration
// window at sslp 15x45 does ~6.8 MFLOP of matvec per scenario against 46
// threefry calls (~5k integer operations); what synthesis saves is the
// (S, m) bl/bu reads, 2*m*4 bytes per scenario.
//
// Arithmetic modes (compile-time template):
//   MODE_F32    IEEE f32 fused multiply-add;
//   MODE_BF16   one product of bf16-rounded operands (hi*hi);
//   MODE_BF16X3 hi*hi + hi*lo + lo*hi of bf16 splits (rounded with
//               __float2bfloat16_rn), accumulated in f32; bf16 x bf16
//               products are exact in f32.
// A'y is computed column-parallel (one thread per column); A v is one
// warp per row with a fixed-order butterfly reduction, so the kernel is
// deterministic.
//
// Build (ops/pdhg_window.py::build): each source compiled on its own,
// all at once, with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
// -O3 -Xcompiler -fPIC -c, then nvcc -shared links pdhg_window.o,
// pdhg_window_resident.o, pdhg_window_cones.o and pdhg_window_split.o
// into libpdhg_window.so
// (no fast-math: sqrtf and the division stay IEEE).
// Bound to Python with ctypes (ops/pdhg_window.py) through one entry,
// pdhg_window_launch: the caller names the design; the instantiation
// follows from the inputs (SOC blocks when num_cones > 0, SYNTH when
// d_row is given, else box rows).
#include "pdhg_window_common.cuh"

namespace pdhg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// shared-memory floats per scenario: eight n-vectors, six m-vectors, and
// with cones a seventh m-vector holding w on SOC rows
__host__ __device__ inline long long smem_floats(int m, int n, bool cones) {
  return 8LL * n + (cones ? 7LL : 6LL) * m;
}

// shared-memory ints of the cone layout: CSR offsets, CSR rows, and a
// per-row SOC flag
__host__ __device__ inline long long cone_ints(const Args& g) {
  return (long long)g.num_cones + 1 + g.cone_nnz + g.m;
}

template <int MODE, int SPB, bool CONES, bool SYNTH>
__global__ void __launch_bounds__(kThreads)
pdhg_window_kernel(Args g) {
  extern __shared__ float smem[];
  const int m = g.m, n = g.n;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * SPB;
  const long long per = smem_floats(m, n, CONES);

  // per-scenario shared-memory vectors
  float* base = smem;
  float* x_[SPB]; float* xs_[SPB]; float* tc_[SPB]; float* pre_[SPB];
  float* l_[SPB]; float* u_[SPB]; float* vh_[SPB]; float* vl_[SPB];
  float* y_[SPB]; float* ys_[SPB]; float* sbl_[SPB]; float* sbu_[SPB];
  float* yh_[SPB]; float* yl_[SPB]; float* w_[SPB];
  __shared__ float tau_s[SPB], sigma_s[SPB];
  __shared__ bool frozen_s[SPB];
  __shared__ unsigned key_s[SPB][2];  // SYNTH: each scenario's key
#pragma unroll
  for (int s = 0; s < SPB; ++s) {
    float* b = base + s * per;
    x_[s] = b;          xs_[s] = b + n;      tc_[s] = b + 2 * n;
    pre_[s] = b + 3 * n; l_[s] = b + 4 * n;  u_[s] = b + 5 * n;
    vh_[s] = b + 6 * n; vl_[s] = b + 7 * n;
    float* r = b + 8 * n;
    y_[s] = r;          ys_[s] = r + m;      sbl_[s] = r + 2 * m;
    sbu_[s] = r + 3 * m; yh_[s] = r + 4 * m; yl_[s] = r + 5 * m;
    w_[s] = r + 6 * m;  // CONES only
  }
  // cone layout after the scenarios' state (CONES only)
  int* cptr = reinterpret_cast<int*>(base + SPB * per);
  int* crows = cptr + g.num_cones + 1;
  int* soc_row = crows + g.cone_nnz;

  // ---- load: hoisted loop invariants (tc, pre, sigma*bl, sigma*bu) ----
  if (tid < SPB) {
    const int sc = s0 + tid;
    float t = 0.f, sg = 0.f, live = 0.f;
    if (sc < g.S) {
      live = 1.0f - g.done[sc];
      t = g.tau[sc] * live;
      sg = g.sigma[sc] * live;
    }
    tau_s[tid] = t;
    sigma_s[tid] = sg;
    frozen_s[tid] = live == 0.f;
    if (SYNTH) scenario_key(g, sc, key_s[tid][0], key_s[tid][1]);
  }
  if (CONES) {
    for (int k = tid; k <= g.num_cones; k += kThreads)
      cptr[k] = g.cone_ptr[k];
    for (int k = tid; k < g.cone_nnz; k += kThreads)
      crows[k] = g.cone_rows[k];
    for (int i = tid; i < m; i += kThreads) soc_row[i] = 0;
  }
  __syncthreads();
  if (CONES) {
    for (int k = tid; k < g.cone_nnz; k += kThreads) soc_row[crows[k]] = 1;
  }
#pragma unroll
  for (int s = 0; s < SPB; ++s) {
    const int sc = s0 + s;
    const bool valid = sc < g.S;
    const float t = tau_s[s], sg = sigma_s[s];
    for (int j = tid; j < n; j += kThreads) {
      float xv = 0.f, xsv = 0.f, cv = 0.f, qv = 0.f, lv = 0.f, uv = 0.f;
      if (valid) {
        xv = g.x[(long long)sc * n + j];
        xsv = g.xs[(long long)sc * n + j];
        cv = g.c[sc * g.c_stride + j];
        qv = g.q[sc * g.q_stride + j];
        lv = g.l[sc * g.l_stride + j];
        uv = g.u[sc * g.u_stride + j];
      }
      x_[s][j] = xv;
      xs_[s][j] = xsv;
      tc_[s][j] = t * cv;
      pre_[s][j] = 1.0f / (1.0f + t * qv);
      l_[s][j] = lv;
      u_[s][j] = uv;
    }
    for (int i = tid; i < m; i += kThreads) {
      float yv = 0.f, ysv = 0.f, blv = 0.f, buv = 0.f;
      if (valid) {
        yv = g.y[(long long)sc * m + i];
        ysv = g.ys[(long long)sc * m + i];
        row_bounds<SYNTH>(g, sc, i, key_s[s][0], key_s[s][1], blv, buv);
      }
      y_[s][i] = yv;
      ys_[s][i] = ysv;
      sbl_[s][i] = sg * blv;
      sbu_[s][i] = sg * buv;
    }
  }
  __syncthreads();

  for (int it = 0; it < g.n_iters; ++it) {
    // ---- split y for the bf16 modes ----
    if (MODE != MODE_F32) {
#pragma unroll
      for (int s = 0; s < SPB; ++s) {
        for (int i = tid; i < m; i += kThreads) {
          const float v = y_[s][i];
          const float hi = bf16_round(v);
          yh_[s][i] = hi;
          yl_[s][i] = MODE == MODE_BF16X3 ? bf16_round(v - hi) : 0.f;
        }
      }
      __syncthreads();
    }
    // ---- primal step: A'y column-parallel, then the box prox ----
    for (int j = tid; j < n; j += kThreads) {
      float acc[SPB];
#pragma unroll
      for (int s = 0; s < SPB; ++s) acc[s] = 0.f;
      for (int i = 0; i < m; ++i) {
        const float a = g.A[(long long)i * n + j];
        const float alo = MODE == MODE_BF16X3 ? g.A_lo[(long long)i * n + j]
                                              : 0.f;
#pragma unroll
        for (int s = 0; s < SPB; ++s) {
          const float vh = MODE == MODE_F32 ? y_[s][i] : yh_[s][i];
          const float vl = MODE == MODE_BF16X3 ? yl_[s][i] : 0.f;
          acc[s] = mac<MODE>(acc[s], a, alo, vh, vl);
        }
      }
#pragma unroll
      for (int s = 0; s < SPB; ++s) {
        const float xv = x_[s][j];
        float x1 = xv - tau_s[s] * acc[s];
        x1 = (x1 - tc_[s][j]) * pre_[s][j];
        x1 = frozen_s[s] ? xv : clip(x1, l_[s][j], u_[s][j]);
        x_[s][j] = x1;
        xs_[s][j] += x1;
        const float v = 2.0f * x1 - xv;
        if (MODE == MODE_F32) {
          vh_[s][j] = v;
        } else {
          const float hi = bf16_round(v);
          vh_[s][j] = hi;
          vl_[s][j] = MODE == MODE_BF16X3 ? bf16_round(v - hi) : 0.f;
        }
      }
    }
    __syncthreads();
    // ---- dual step: A v one warp per row, then the box-row prox; SOC
    //      rows leave w for the cone step ----
    for (int i = warp; i < m; i += kWarps) {
      float acc[SPB];
#pragma unroll
      for (int s = 0; s < SPB; ++s) acc[s] = 0.f;
      const float* Arow = g.A + (long long)i * n;
      const float* Arow_lo =
          MODE == MODE_BF16X3 ? g.A_lo + (long long)i * n : nullptr;
      for (int j = lane; j < n; j += 32) {
        const float a = Arow[j];
        const float alo = MODE == MODE_BF16X3 ? Arow_lo[j] : 0.f;
#pragma unroll
        for (int s = 0; s < SPB; ++s)
          acc[s] = mac<MODE>(acc[s], a, alo, vh_[s][j],
                             MODE == MODE_BF16X3 ? vl_[s][j] : 0.f);
      }
#pragma unroll
      for (int s = 0; s < SPB; ++s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
      }
      if (lane == 0) {
        const bool soc = CONES && soc_row[i];
#pragma unroll
        for (int s = 0; s < SPB; ++s) {
          const float w = y_[s][i] + sigma_s[s] * acc[s];
          if (soc) {
            w_[s][i] = w;
            continue;
          }
          const float y1 = frozen_s[s]
                               ? y_[s][i]
                               : w - clip(w, sbl_[s][i], sbu_[s][i]);
          y_[s][i] = y1;
          ys_[s][i] += y1;
        }
      }
    }
    __syncthreads();
    // ---- cone step: one thread per (scenario, SOC block) ----
    if (CONES) {
      for (int task = tid; task < SPB * g.num_cones; task += kThreads) {
        const int s = task / g.num_cones, k = task - s * g.num_cones;
        float* r = base + s * per + 8 * n;
        soc_block(crows + cptr[k], cptr[k + 1] - cptr[k], 1, frozen_s[s],
                  r + 6 * m, r + 2 * m, r, r + m);
      }
      __syncthreads();
    }
  }

  // ---- write back ----
#pragma unroll
  for (int s = 0; s < SPB; ++s) {
    const int sc = s0 + s;
    if (sc >= g.S) continue;
    for (int j = tid; j < n; j += kThreads) {
      g.xo[(long long)sc * n + j] = x_[s][j];
      g.xso[(long long)sc * n + j] = xs_[s][j];
    }
    for (int i = tid; i < m; i += kThreads) {
      g.yo[(long long)sc * m + i] = y_[s][i];
      g.yso[(long long)sc * m + i] = ys_[s][i];
    }
  }
}

template <int SPB, bool CONES>
size_t smem_bytes(const Args& g) {
  return sizeof(float) * SPB * smem_floats(g.m, g.n, CONES) +
         (CONES ? sizeof(int) * cone_ints(g) : 0);
}

template <int MODE, int SPB, bool CONES, bool SYNTH>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  const size_t bytes = smem_bytes<SPB, CONES>(g);
  cudaError_t err = cudaFuncSetAttribute(
      pdhg_window_kernel<MODE, SPB, CONES, SYNTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (g.S + SPB - 1) / SPB;
  pdhg_window_kernel<MODE, SPB, CONES, SYNTH>
      <<<blocks, kThreads, bytes, stream>>>(g);
  return cudaGetLastError();
}

// Scenarios per block (the plan's tile): 4 once the batch fills the
// card, else 1 so a small batch still spreads over the SMs.
template <int MODE, bool CONES, bool SYNTH>
cudaError_t dispatch_spb(const Args& g, int tile, cudaStream_t stream) {
  if (tile == 4) return launch<MODE, 4, CONES, SYNTH>(g, stream);
  if (tile == 1) return launch<MODE, 1, CONES, SYNTH>(g, stream);
  return cudaErrorInvalidValue;
}

// box rows, SOC blocks, or box rows with in-kernel synthesis (the entry
// rejects synthesis together with cones)
template <int MODE>
cudaError_t dispatch_kind(const Args& g, int tile, cudaStream_t stream) {
  if (g.d_row != nullptr)
    return dispatch_spb<MODE, false, true>(g, tile, stream);
  if (g.num_cones > 0) return dispatch_spb<MODE, true, false>(g, tile, stream);
  return dispatch_spb<MODE, false, false>(g, tile, stream);
}

cudaError_t dispatch_streamed(const Args& g, int mode, int tile,
                              cudaStream_t st) {
  switch (mode) {
    case MODE_F32: return dispatch_kind<MODE_F32>(g, tile, st);
    case MODE_BF16: return dispatch_kind<MODE_BF16>(g, tile, st);
    case MODE_BF16X3:
      if (g.A_lo == nullptr) return cudaErrorInvalidValue;
      return dispatch_kind<MODE_BF16X3>(g, tile, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace pdhg

// The card's limits that the shape rule reads: opt-in shared memory per
// block and the SM count of the current device.
extern "C" int pdhg_window_limits(int* smem_per_block, int* sm_count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
  return (int)err;
}

// The resident design's shared memory and packed-A bytes for a shape
// (0 outside its layout): ops/pdhg_window.py checks its own layout
// against these.
extern "C" long long pdhg_window_resident_bytes(int mode, int m, int n,
                                                int image) {
  return (long long)(image ? pdhg::resident_image_bytes(mode, m, n)
                           : pdhg::resident_smem_bytes(mode, m, n));
}

// design 0 runs the streamed kernel with `tile` (1 or 4) scenarios per
// block from A (and, in bf16x3, A_lo); design 1 runs a resident kernel in
// `blocks` persistent blocks from the packed image a_img of a_img_bytes
// bytes: for box rows pdhg_window_resident.cu (ops/pdhg_window.py::
// pack_resident), for SOC blocks pdhg_window_cones.cu with `tile` (8, 16
// or 24) scenarios per tile (ops/pdhg_window.py::pack_cones); design 2
// runs the split kernel (pdhg_window_split.cu) from A (and A_lo) in
// `blocks` = S x `tile` blocks, `tile` of them per problem, with A's
// column slab in shared memory when split_res, split_part the (S, tile,
// m) scratch, split_bar two zeroed words and split_layout the SOC row
// partition (null without cones).
// ops/pdhg_window.py::plan_window chooses; a launch that the chosen
// design cannot take returns an error and is never retried on another.
// The synthesis arguments (key0 .. d_row, see SYNTH above) are read only
// when d_row is not null; bl/bu then hold the shared scaled template that
// rows outside the draw keep.
extern "C" int pdhg_window_launch(
    int design, int tile, int blocks, const void* a_img,
    long long a_img_bytes,
    const float* A, const float* A_lo, int m, int n, int S, int n_iters,
    int mode, const float* tau, const float* sigma, const float* done,
    const float* c, long long c_stride, const float* q, long long q_stride,
    const float* l, long long l_stride, const float* u, long long u_stride,
    const float* bl, long long bl_stride, const float* bu,
    long long bu_stride, const int* cone_ptr, const int* cone_rows,
    int num_cones, int cone_nnz, const float* x, const float* y,
    const float* xs, const float* ys, float* xo, float* yo, float* xso,
    float* yso, unsigned key0, unsigned key1, int start, int num_real,
    int draw_row0, int draw_count, float draw_thr, float draw_below,
    float draw_above, int draw_bl, int draw_bu, const float* d_row,
    int split_res, float* split_part, unsigned* split_bar,
    const int* split_layout, void* stream) {
  using pdhg::Args;
  if (S <= 0) return 0;
  if (m <= 0 || n <= 0 || n_iters < 0) return (int)cudaErrorInvalidValue;
  if (num_cones < 0 || cone_nnz < 0 ||
      (num_cones > 0 && (cone_ptr == nullptr || cone_rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (d_row != nullptr &&
      (num_cones > 0 || num_real <= 0 || start < 0 || draw_row0 < 0 ||
       draw_count < 0 || draw_row0 + draw_count > m))
    return (int)cudaErrorInvalidValue;
  Args g{A, A_lo, a_img, m, n, S, n_iters, tau, sigma, done,
         c, c_stride, q, q_stride, l, l_stride, u, u_stride,
         bl, bl_stride, bu, bu_stride, cone_ptr, cone_rows, num_cones,
         cone_nnz, x, y, xs, ys, xo, yo, xso, yso,
         key0, key1, start, num_real, draw_row0, draw_count,
         draw_thr, draw_below, draw_above, draw_bl, draw_bu, d_row};
  const cudaStream_t st = (cudaStream_t)stream;
  if (design == 0) return (int)pdhg::dispatch_streamed(g, mode, tile, st);
  if (design == 2) {
    if ((long long)S * tile != blocks) return (int)cudaErrorInvalidValue;
    return (int)pdhg::launch_split(g, mode, tile, split_res != 0, split_part,
                                   split_bar, split_layout, st);
  }
  if (design != 1 || a_img == nullptr) return (int)cudaErrorInvalidValue;
  if (num_cones > 0) {
    if (a_img_bytes != (long long)pdhg::cones_image_bytes(mode, m, n))
      return (int)cudaErrorInvalidValue;
    return (int)pdhg::launch_cones(g, mode, tile, blocks, st);
  }
  if (a_img_bytes != (long long)pdhg::resident_image_bytes(mode, m, n))
    return (int)cudaErrorInvalidValue;
  return (int)pdhg::launch_resident(g, mode, blocks, st);
}
