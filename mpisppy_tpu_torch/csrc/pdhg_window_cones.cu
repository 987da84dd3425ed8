// The PDHG restart window for batches with second-order-cone rows, with
// A resident in shared memory: the same function as the streamed
// kernel's CONES instantiation (pdhg_window.cu), redesigned for Hopper
// at the shape of the ccopf --soc relaxation (the 4-bus feeder: n = 81,
// m = 69, 9 SOC blocks of 4 rows, 33 box rows).
//
// Replaces, for cone batches whose A fits, mpisppy_tpu/ops/pdhg_pallas.py
// ::_tile_math.soc_prox (:192, selected at :221) and _membership_padded
// (:258) inside the window reached from pallas_call at :491 and :663.
//
// What bounds it on an H100: 4*m*n multiply-adds per scenario and
// iteration from a 22 KB A.  The streamed kernel re-read A from L2 twice
// per iteration for every 4 scenarios, kept 81 of its 256 threads busy
// in A'y, reduced A v with a warp shuffle per row and ran the cone step
// on 36 threads.  Here each persistent block copies A into shared memory
// once per launch (cp.async, 16 bytes a thread) and walks tiles of
// T = 8, 16 or 24 scenarios (template G = T / 8 groups of 8):
//   A'y    one task per (column, group): a dot over the m rows, each A
//          element read from shared memory feeding 8 FMAs against y
//          broadcast from shared memory, then the box prox of its 8
//          scenarios (n * G tasks: 243 of 256 threads at T = 24);
//   A v    one task per (row, group): a dot over the n columns with no
//          shuffle reduction, then the box prox, or w kept for the cone
//          step on SOC rows (m * G tasks: 207 at T = 24);
//   cones  one thread per (scenario, block) over the whole tile: soc_block
//          of pdhg_window_common.cuh, the streamed kernel's projection
//          (T * blocks tasks: 216 at T = 24).  Blocks may be ragged, in
//          any row order and any number; they arrive as CSR.
// The tile's state lives in shared memory for the whole window as
// [index][T] arrays (x, its window sum, tau*c, 1/(1 + tau*q), l, u and
// v; y, its window sum, sigma*bl, sigma*bu, w, and in the bf16 modes the
// hi/lo split of y): at ccopf's shape ~3.6 KB a scenario, 110 KB a block
// in f32 at T = 24 with A, so two blocks share an SM (__launch_bounds__
// (256, 2), and the launch asks for the SM's whole unified memory as
// shared memory).  Per tile-iteration at T = 24 that is ~268k FMAs, and
// every 8 of them read one A element and two float4 of y or v from
// shared memory.
//
// Which T: ops/pdhg_window.py::plan_window takes the fewest rounds of
// tiles over the card's block slots (blocks per SM x SMs), then the
// smallest T.  At ccopf's S = 10,000 that is T = 24 (417 tiles, 2 rounds
// over 264 slots in f32); at the fused wheel's 64-scenario, 160-iteration
// straggler tail, T = 8 (8 tiles on 8 SMs: one round whatever T).  A
// tile alone on its SM is bound by the latency of its dots, so at T = 8
// each dot is split in kParts = 3 over its sum index (rows of A'y,
// columns of A v): 243 tasks at ccopf's shape, each a third as long, and
// their partial sums meet in shared memory in a fixed order behind one
// more barrier per step.
//
// Arithmetic: f32 as IEEE fmaf (no TF32, no fast-math); bf16 and bf16x3
// on CUDA cores through mac<MODE> of pdhg_window_common.cuh, from A's hi
// (and lo) planes stored as f32 values (packed by ops/pdhg_window.py::
// pack_cones) and y, v split with __float2bfloat16_rn when written; the
// SOC projection in IEEE f32 in every mode.  Tensor cores are out of
// scope: ccopf's wheel runs f32, which they cannot give.
//
// Semantics as the streamed kernel: done lanes run with tau = sigma = 0,
// keep x and y bit for bit (the cone branch too) and keep accumulating
// their window sums; infinite row bounds are clipped to +-1e30 before
// sigma scales them; pad scenarios of the last tile are frozen zeros and
// never written; shared (stride-0) c, q, l, u, bl and bu are read from
// their one row; every dot runs in a fixed order without atomics, so the
// kernel is deterministic.
//
// Layout limit: the layout's shared memory within the card's per-block
// limit at T = 8 (the 33-bus feeder's 2.1 MB A is not; it stays on the
// streamed kernel).
#include "pdhg_window_common.cuh"

namespace pdhg {
namespace {

constexpr int kThreads = 256;
constexpr int kW = 8;        // scenarios per task: two float4 of y or v
constexpr int kMaxT = 24;    // scenarios per tile: 1, 2 or 3 groups

// Shared-memory layout for (mode, m, n, T): A's planes (f32 values, row
// stride n | 1, so that rows read by neighbouring threads fall on
// distinct banks), then the n-vectors and the m-vectors of the tile as
// [index][T], then the partial sums of the split dots, then the cone
// layout's ints.  Offsets in floats.
struct ConeLayout {
  int as, a_floats;     // A row stride; A's planes rounded to 16 bytes
  int n_vecs, m_vecs;   // n- and m-vectors of the tile
  int part_floats;      // partial sums of the split dots (T = 8 only)
  size_t bytes;
};

inline int planes_of(int mode) { return mode == MODE_BF16X3 ? 2 : 1; }

// the dots of a T = 8 tile are split in kParts over their sum index
constexpr int kParts = 3;
inline int parts_of(int T) { return T == 8 ? kParts : 1; }

bool make_layout(int mode, int m, int n, int T, int cone_ints,
                 ConeLayout& L) {
  if (m <= 0 || n <= 0 || cone_ints <= 0 || (T != 8 && T != 16 && T != 24))
    return false;
  if (mode != MODE_F32 && mode != MODE_BF16 && mode != MODE_BF16X3)
    return false;
  L.as = n | 1;
  L.a_floats = (planes_of(mode) * m * L.as + 3) / 4 * 4;
  // x, xs, tc, pre, l, u, then v (f32 / bf16 hi) and in bf16x3 v's lo
  L.n_vecs = 6 + (mode == MODE_BF16X3 ? 2 : 1);
  // y, ys, sbl, sbu, w, then y's hi (bf16, bf16x3) and lo (bf16x3)
  L.m_vecs = 5 + (mode == MODE_F32 ? 0 : mode == MODE_BF16 ? 1 : 2);
  L.part_floats = parts_of(T) > 1 ? parts_of(T) * T * (m > n ? m : n) : 0;
  L.bytes = sizeof(float) * ((size_t)L.a_floats +
                             (size_t)T * (L.n_vecs * n + L.m_vecs * m) +
                             L.part_floats) +
            sizeof(int) * (size_t)cone_ints;
  return true;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// the 8 floats of one task (16-byte aligned: T and every base are
// multiples of 4 floats)
__device__ __forceinline__ void ld8(float (&v)[kW], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st8(float* p, const float (&v)[kW]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// v as the products read it: f32 as is; bf16 its hi part; bf16x3 hi and lo
template <int MODE>
__device__ __forceinline__ void split_store(float* hi, float* lo, float v) {
  if (MODE == MODE_F32) {
    *hi = v;
    return;
  }
  const float h = bf16_round(v);
  *hi = h;
  if (MODE == MODE_BF16X3) *lo = bf16_round(v - h);
}

template <int MODE, int G>
__global__ void __launch_bounds__(kThreads, 2)
pdhg_window_cones(Args g, ConeLayout L) {
  constexpr int T = kW * G;
  constexpr int P = G == 1 ? kParts : 1;  // parts of each dot
  constexpr bool LO = MODE == MODE_BF16X3;
  extern __shared__ __align__(16) float sm[];
  __shared__ float tau_s[kMaxT], sigma_s[kMaxT];
  __shared__ int frozen_s[kMaxT];
  const int tid = threadIdx.x;
  const int m = g.m, n = g.n, as = L.as;
  const int nT = n * T, mT = m * T;

  // ---- A once per block: the packed image, 16 bytes a thread ----
  {
    const char* src = static_cast<const char*>(g.A_img);
    char* dst = reinterpret_cast<char*>(sm);
    for (int k = tid; k < L.a_floats / 4; k += kThreads)
      cp_async16(dst + 16 * k, src + 16 * k);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const float* Ah = sm;
  const float* Al = sm + m * as;  // bf16x3 only
  float* X = sm + L.a_floats;
  float* XS = X + nT;
  float* TC = XS + nT;
  float* PRE = TC + nT;
  float* LB = PRE + nT;
  float* UB = LB + nT;
  float* Vh = UB + nT;
  float* Vl = Vh + nT;            // bf16x3 only
  float* Y = X + L.n_vecs * nT;
  float* YS = Y + mT;
  float* SBL = YS + mT;
  float* SBU = SBL + mT;
  float* W = SBU + mT;
  float* Yh = MODE == MODE_F32 ? Y : W + mT;   // the operand of A'y
  float* Yl = W + 2 * mT;                      // bf16x3 only
  float* PS = Y + L.m_vecs * mT;  // partial sums, P > 1 only
  int* cptr = reinterpret_cast<int*>(PS + L.part_floats);
  int* crows = cptr + g.num_cones + 1;
  int* soc_row = crows + g.cone_nnz;

  // acc = sum over t < len of a[t * astep] * op[t * T] for the task's 8
  // scenarios, in the mode's arithmetic, in order of t
  auto dot = [&](float (&acc)[kW], const float* a, const float* alo,
                 int astep, const float* oph, const float* opl, int len) {
#pragma unroll
    for (int k = 0; k < kW; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float av = a[t * astep];
      const float al = LO ? alo[t * astep] : 0.f;
      float vh[kW], vl[kW];
      ld8(vh, oph + t * T);
      if (LO) ld8(vl, opl + t * T);
#pragma unroll
      for (int k = 0; k < kW; ++k)
        acc[k] = mac<MODE>(acc[k], av, al, vh[k], LO ? vl[k] : 0.f);
    }
  };
  // acc = the P partial sums at p, p + stride, ..., added in order
  auto sum_parts = [&](float (&acc)[kW], const float* p, int stride) {
    ld8(acc, p);
#pragma unroll
    for (int q = 1; q < P; ++q) {
      float part[kW];
      ld8(part, p + q * stride);
#pragma unroll
      for (int k = 0; k < kW; ++k) acc[k] += part[k];
    }
  };
  // x1 = clip((x - tau*A'y - tau*c) * pre, l, u) for column j of the 8
  // scenarios at o; the window sum and v = 2 x1 - x
  auto primal_prox = [&](int j, int o, const float (&acc)[kW]) {
    const int b = j * T + o;
    float xv[kW], xs[kW], tc[kW], pre[kW], lv[kW], uv[kW], v[kW];
    ld8(xv, X + b);
    ld8(xs, XS + b);
    ld8(tc, TC + b);
    ld8(pre, PRE + b);
    ld8(lv, LB + b);
    ld8(uv, UB + b);
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int s = o + k;
      float x1 = xv[k] - tau_s[s] * acc[k];
      x1 = (x1 - tc[k]) * pre[k];
      x1 = frozen_s[s] ? xv[k] : clip(x1, lv[k], uv[k]);
      v[k] = 2.0f * x1 - xv[k];
      xv[k] = x1;
      xs[k] += x1;
    }
    st8(X + b, xv);
    st8(XS + b, xs);
    if (MODE == MODE_F32) {
      st8(Vh + b, v);
    } else {
#pragma unroll
      for (int k = 0; k < kW; ++k)
        split_store<MODE>(Vh + b + k, Vl + b + k, v[k]);
    }
  };
  // w = y + sigma*A v for row i of the 8 scenarios at o: the box-row
  // prox, or w left for the cone step on a SOC row
  auto dual_prox = [&](int i, int o, const float (&acc)[kW]) {
    const int b = i * T + o;
    float yv[kW], w[kW];
    ld8(yv, Y + b);
#pragma unroll
    for (int k = 0; k < kW; ++k) w[k] = yv[k] + sigma_s[o + k] * acc[k];
    if (soc_row[i]) {
      st8(W + b, w);
      return;
    }
    float ys[kW], lo[kW], hi[kW];
    ld8(ys, YS + b);
    ld8(lo, SBL + b);
    ld8(hi, SBU + b);
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const float y1 =
          frozen_s[o + k] ? yv[k] : w[k] - clip(w[k], lo[k], hi[k]);
      yv[k] = y1;
      ys[k] += y1;
    }
    st8(Y + b, yv);
    st8(YS + b, ys);
    if (MODE != MODE_F32) {
#pragma unroll
      for (int k = 0; k < kW; ++k)
        split_store<MODE>(Yh + b + k, Yl + b + k, yv[k]);
    }
  };

  // ---- the cone layout once per block ----
  for (int k = tid; k <= g.num_cones; k += kThreads) cptr[k] = g.cone_ptr[k];
  for (int k = tid; k < g.cone_nnz; k += kThreads) crows[k] = g.cone_rows[k];
  for (int i = tid; i < m; i += kThreads) soc_row[i] = 0;
  __syncthreads();
  for (int k = tid; k < g.cone_nnz; k += kThreads) soc_row[crows[k]] = 1;

  const int tiles = (g.S + T - 1) / T;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s0 = tile * T;
    __syncthreads();  // the last tile's write-back is done with the state
    // ---- load: per-scenario scalars, then the hoisted invariants ----
    if (tid < T) {
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
    }
    __syncthreads();
    // element e of the tile's (T, n) block: contiguous in device memory
    for (int e = tid; e < nT; e += kThreads) {
      const int s = e / n, j = e - s * n, sc = s0 + s;
      float xv = 0.f, xsv = 0.f, cv = 0.f, qv = 0.f, lv = 0.f, uv = 0.f;
      if (sc < g.S) {
        xv = g.x[(long long)sc * n + j];
        xsv = g.xs[(long long)sc * n + j];
        cv = g.c[sc * g.c_stride + j];
        qv = g.q[sc * g.q_stride + j];
        lv = g.l[sc * g.l_stride + j];
        uv = g.u[sc * g.u_stride + j];
      }
      const float t = tau_s[s];
      const int k = j * T + s;
      X[k] = xv;
      XS[k] = xsv;
      TC[k] = t * cv;
      PRE[k] = 1.0f / (1.0f + t * qv);
      LB[k] = lv;
      UB[k] = uv;
    }
    for (int e = tid; e < mT; e += kThreads) {
      const int s = e / m, i = e - s * m, sc = s0 + s;
      float yv = 0.f, ysv = 0.f, blv = 0.f, buv = 0.f;
      if (sc < g.S) {
        yv = g.y[(long long)sc * m + i];
        ysv = g.ys[(long long)sc * m + i];
        row_bounds<false>(g, sc, i, 0u, 0u, blv, buv);
      }
      const float sg = sigma_s[s];
      const int k = i * T + s;
      Y[k] = yv;
      YS[k] = ysv;
      SBL[k] = sg * blv;
      SBU[k] = sg * buv;
      if (MODE != MODE_F32) split_store<MODE>(Yh + k, Yl + k, yv);
    }
    if (first) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      first = false;
    }
    __syncthreads();

    for (int it = 0; it < g.n_iters; ++it) {
      // ---- primal step: A'y per (column, group[, part]), then the box
      //      prox ----
      for (int task = tid; task < n * G * P; task += kThreads) {
        const int part = task / (n * G), r = task - part * (n * G);
        const int grp = r / n, j = r - grp * n, o = kW * grp;
        const int i0 = part * m / P, i1 = (part + 1) * m / P;
        float acc[kW];
        dot(acc, Ah + i0 * as + j, Al + i0 * as + j, as, Yh + i0 * T + o,
            Yl + i0 * T + o, i1 - i0);
        if (P == 1)
          primal_prox(j, o, acc);
        else
          st8(PS + part * nT + j * T + o, acc);
      }
      if (P > 1) {
        __syncthreads();
        for (int task = tid; task < n * G; task += kThreads) {
          const int grp = task / n, j = task - grp * n, o = kW * grp;
          float acc[kW];
          sum_parts(acc, PS + j * T + o, nT);
          primal_prox(j, o, acc);
        }
      }
      __syncthreads();
      // ---- dual step: A v per (row, group[, part]), then the box-row
      //      prox; SOC rows leave w for the cone step ----
      for (int task = tid; task < m * G * P; task += kThreads) {
        const int part = task / (m * G), r = task - part * (m * G);
        const int grp = r / m, i = r - grp * m, o = kW * grp;
        const int j0 = part * n / P, j1 = (part + 1) * n / P;
        float acc[kW];
        dot(acc, Ah + i * as + j0, Al + i * as + j0, 1, Vh + j0 * T + o,
            Vl + j0 * T + o, j1 - j0);
        if (P == 1)
          dual_prox(i, o, acc);
        else
          st8(PS + part * mT + i * T + o, acc);
      }
      if (P > 1) {
        __syncthreads();
        for (int task = tid; task < m * G; task += kThreads) {
          const int grp = task / m, i = task - grp * m, o = kW * grp;
          float acc[kW];
          sum_parts(acc, PS + i * T + o, mT);
          dual_prox(i, o, acc);
        }
      }
      __syncthreads();
      // ---- cone step: one thread per (scenario, SOC block) ----
      for (int task = tid; task < T * g.num_cones; task += kThreads) {
        const int k = task / T, s = task - k * T;
        const int* rows = crows + cptr[k];
        const int dim = cptr[k + 1] - cptr[k];
        soc_block(rows, dim, T, frozen_s[s], W + s, SBL + s, Y + s, YS + s);
        if (MODE != MODE_F32) {
          for (int r = 0; r < dim; ++r) {
            const int e = rows[r] * T + s;
            split_store<MODE>(Yh + e, Yl + e, Y[e]);
          }
        }
      }
      __syncthreads();
    }

    // ---- write back ----
    for (int e = tid; e < nT; e += kThreads) {
      const int s = e / n, j = e - s * n, sc = s0 + s;
      if (sc < g.S) {
        g.xo[(long long)sc * n + j] = X[j * T + s];
        g.xso[(long long)sc * n + j] = XS[j * T + s];
      }
    }
    for (int e = tid; e < mT; e += kThreads) {
      const int s = e / m, i = e - s * m, sc = s0 + s;
      if (sc < g.S) {
        g.yo[(long long)sc * m + i] = Y[i * T + s];
        g.yso[(long long)sc * m + i] = YS[i * T + s];
      }
    }
  }
  if (first) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MODE, int G>
cudaError_t launch(const Args& g, const ConeLayout& L, int blocks,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pdhg_window_cones<MODE, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  // all of the SM's unified memory as shared memory, so that two blocks
  // fit where the layout allows it
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pdhg_window_cones<MODE, G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  pdhg_window_cones<MODE, G><<<blocks, kThreads, L.bytes, stream>>>(g, L);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_tile(const Args& g, const ConeLayout& L, int tile,
                        int blocks, cudaStream_t stream) {
  switch (tile) {
    case 8: return launch<MODE, 1>(g, L, blocks, stream);
    case 16: return launch<MODE, 2>(g, L, blocks, stream);
    case 24: return launch<MODE, 3>(g, L, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

size_t cones_smem_bytes(int mode, int m, int n, int tile, int cone_ints) {
  ConeLayout L;
  return make_layout(mode, m, n, tile, cone_ints, L) ? L.bytes : 0;
}

size_t cones_image_bytes(int mode, int m, int n) {
  ConeLayout L;
  return make_layout(mode, m, n, 8, 1, L) ? sizeof(float) * L.a_floats : 0;
}

cudaError_t launch_cones(const Args& g, int mode, int tile, int blocks,
                         cudaStream_t stream) {
  ConeLayout L;
  if (g.num_cones <= 0 || g.d_row != nullptr || g.A_img == nullptr ||
      blocks <= 0 ||
      !make_layout(mode, g.m, g.n, tile,
                   g.num_cones + 1 + g.cone_nnz + g.m, L))
    return cudaErrorInvalidValue;
  switch (mode) {
    case MODE_F32: return launch_tile<MODE_F32>(g, L, tile, blocks, stream);
    case MODE_BF16: return launch_tile<MODE_BF16>(g, L, tile, blocks, stream);
    case MODE_BF16X3:
      return launch_tile<MODE_BF16X3>(g, L, tile, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pdhg

// The resident SOC design's shared memory (image = 0) or packed-A bytes
// (image = 1) for a shape, 0 outside its layout: ops/pdhg_window.py
// checks its own cone_layout against these.
extern "C" long long pdhg_window_cones_bytes(int mode, int m, int n, int tile,
                                             int cone_ints, int image) {
  return (long long)(image ? pdhg::cones_image_bytes(mode, m, n)
                           : pdhg::cones_smem_bytes(mode, m, n, tile,
                                                    cone_ints));
}
