// The PDHG restart window split over a cooperative grid: the function of
// the streamed kernel (pdhg_window.cu; box rows and SOC blocks), with one
// problem's columns and rows cut into P slabs over P blocks, so that a
// batch of one problem (a sampled EF, an L-shaped master, a root-fixed
// EF) or of a few runs on the whole card instead of one SM.
//
// Replaces, for small batches of a shape no resident layout takes,
// mpisppy_tpu/ops/pdhg_pallas.py::run_window (_tile_math :116 with the
// SOC dual prox :192, reached from pallas_call at :491 and :663).  The
// streamed kernel keeps a scenario's whole state in one block: at S = 1
// the window ran on one SM of 132 and read A from L2 twice an iteration
// (38 ms for a 660 x 6,345 EF on an H100, against a bound of ~0.01 ms).
//
// What bounds it: 4*m*n multiply-adds an iteration, and two grid
// barriers.  The grid is S x P blocks of 256 threads, launched with
// cudaLaunchCooperativeKernel so that every block is resident at once;
// P = blocks per problem comes from ops/pdhg_window.py::plan_window, and
// the launch refuses a grid the card cannot hold (the occupancy API's
// blocks an SM times the SMs).  Block b of problem s owns
//   columns  J_b = [b*n/P, (b+1)*n/P)  (integer division, the formula of
//            ops/pdhg_window.py::split_columns): x, its window sum,
//            tau*c, 1/(1 + tau*q), l, u and v in shared memory, and
//            A[:, J_b] too where the slab fits (row stride |J|max | 1;
//            f32, or bf16 hi (and lo) planes, which hold the split
//            exactly); else the slab is read from L2 through L1;
//   rows     box rows [b*m/P, (b+1)*m/P), or with SOC blocks the rows
//            of ops/pdhg_window.py::split_rows (whole cones, box rows
//            balanced around them), passed in as `layout`.
// One iteration:
//   primal   stage y (m floats, from the previous iteration's writes,
//            read past L1) and its bf16 split; A[:, J_b]'y, one thread
//            per (row group, column) and the groups summed in order;
//            the box prox on J_b, the window sum, v = 2 x1 - x; then the
//            partial A[:, J_b] v_J, one thread per row, into the (S, P,
//            m) scratch the wrapper allocates;
//   barrier  (one, grid-wide);
//   dual     G = min(32, P rounded up to a power of 2) lanes of a warp
//            per owned row sum the P partials (lane p, p + G, ... in
//            order, then a fixed butterfly), form w = y + sigma*Av
//            and take the box-row prox, or keep w for the cone step:
//            one thread per owned SOC block (soc_block of
//            pdhg_window_common.cuh, IEEE f32 with __fmul_rn/__fadd_rn);
//            the new y of owned rows goes to yo, which the next primal
//            half stages;
//   barrier  (none after the last iteration).
// So a 40-iteration window takes 79 grid barriers.  The barrier is
// written here (an arrive count each block adds to and waits on, with
// __threadfence on both sides; the last block to finish sets it back to
// 0, and the wrapper zeroes the words once per stream), so the build
// needs no relocatable device code.  Every sum runs in a fixed order without atomics: the kernel is
// deterministic.  Tensor cores are out of scope: a matrix-vector
// product of one problem gives them nothing to do; the aim is every
// SM's shared-memory bandwidth.
//
// Semantics as the streamed kernel: done problems run with tau = sigma =
// 0 and keep x and y bit for bit (the cone branch too: Proj_polar(y) is
// not y) while their window sums accumulate; infinite row bounds are
// clipped to +-1e30 first; shared (stride-0) c, q, l, u, bl and bu are
// read from their one row.
#include "pdhg_window_common.cuh"

namespace pdhg {
namespace {

constexpr int kThreads = kSplitThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowGroups = 16;   // A'y: row groups summed in order

struct Split {
  int P;              // blocks per problem
  float* part;        // (S, P, m) partial sums of A v
  unsigned* bar;      // grid barrier: arrive count, blocks finished
  const int* layout;  // SOC row partition (split_rows), null without cones
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier inside a cooperative launch (every block resident):
// each block adds one to the arrive count and waits until the count
// reaches the next multiple of the grid's blocks.  The count starts the
// launch at 0 (grid_done puts it back).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atomicAdd(bar, 1u);
    const unsigned target = (old / blocks + 1u) * blocks;
    while (load_acquire(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The last block to finish (after every barrier of every block) sets the
// arrive count back to 0 for the next launch on the stream.
__device__ __forceinline__ void grid_done(unsigned* bar, unsigned blocks) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == blocks - 1) {
    atomicExch(bar, 0u);
    atomicExch(bar + 1, 0u);
  }
}

template <int MODE, bool CONES, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
pdhg_window_split(Args g, Split sp) {
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int m = g.m, n = g.n, P = sp.P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x / P, b = blockIdx.x - s * P;
  const int c0 = (int)((long long)b * n / P);
  const int w = (int)((long long)(b + 1) * n / P) - c0;
  const int AS = ((n + P - 1) / P) | 1;  // slab row stride
  const int W = (n + P - 1) / P;

  // ---- shared memory: A slab, n-vectors (W), m-vectors, reduction ----
  const size_t a_bytes =
      RES ? split_slab_bytes(MODE, m, n, P) : (size_t)0;
  const float* sA = reinterpret_cast<const float*>(split_smem);
  const __nv_bfloat16* sH =
      reinterpret_cast<const __nv_bfloat16*>(split_smem);
  const __nv_bfloat16* sL = sH + (size_t)m * AS;
  float* x = reinterpret_cast<float*>(split_smem + a_bytes);
  float* xs = x + W;   float* tc = xs + W;  float* pre = tc + W;
  float* lo = pre + W; float* up = lo + W;  float* vh = up + W;
  float* vl = vh + W;
  float* y = vl + W;   float* ys = y + m;   float* sbl = ys + m;
  float* sbu = sbl + m;
  float* yh = sbu + m;                                  // bf16 modes
  float* yl = yh + m;
  float* wv = MODE == MODE_F32 ? sbu + m : yl + m;      // CONES
  float* red = CONES ? wv + m : wv;

  auto a_hi = [&](int i, int jj) -> float {
    if constexpr (!RES) {
      return __ldg(g.A + (long long)i * n + c0 + jj);
    } else if constexpr (MODE == MODE_F32) {
      return sA[i * AS + jj];
    } else {
      return __bfloat162float(sH[i * AS + jj]);
    }
  };
  auto a_lo = [&](int i, int jj) -> float {
    if constexpr (MODE != MODE_BF16X3) {
      return 0.f;
    } else if constexpr (!RES) {
      return __ldg(g.A_lo + (long long)i * n + c0 + jj);
    } else {
      return __bfloat162float(sL[i * AS + jj]);
    }
  };

  // ---- load: the slab, the hoisted loop invariants, the state ----
  __shared__ float t_s, sg_s;
  __shared__ bool frozen_s;
  if (tid == 0) {
    const float live = 1.0f - g.done[s];
    t_s = g.tau[s] * live;
    sg_s = g.sigma[s] * live;
    frozen_s = live == 0.f;
  }
  if constexpr (RES) {
    __nv_bfloat16* dH = reinterpret_cast<__nv_bfloat16*>(split_smem);
    float* dF = reinterpret_cast<float*>(split_smem);
    for (int k = tid; k < m * w; k += kThreads) {
      const int i = k / w, jj = k - i * w;
      const long long at = (long long)i * n + c0 + jj;
      if (MODE == MODE_F32) {
        dF[i * AS + jj] = g.A[at];
      } else {
        // A's hi (and lo) parts are bf16 values: the conversion is exact
        dH[i * AS + jj] = __float2bfloat16_rn(g.A[at]);
        if (MODE == MODE_BF16X3)
          dH[(size_t)m * AS + i * AS + jj] = __float2bfloat16_rn(g.A_lo[at]);
      }
    }
  }
  __syncthreads();
  const float t = t_s, sg = sg_s;
  const bool frozen = frozen_s;
  for (int jj = tid; jj < w; jj += kThreads) {
    const int j = c0 + jj;
    x[jj] = g.x[(long long)s * n + j];
    xs[jj] = g.xs[(long long)s * n + j];
    tc[jj] = t * g.c[s * g.c_stride + j];
    pre[jj] = 1.0f / (1.0f + t * g.q[s * g.q_stride + j]);
    lo[jj] = g.l[s * g.l_stride + j];
    up[jj] = g.u[s * g.u_stride + j];
  }
  for (int i = tid; i < m; i += kThreads) {
    float blv, buv;
    row_bounds<false>(g, s, i, 0u, 0u, blv, buv);
    y[i] = g.y[(long long)s * m + i];
    ys[i] = g.ys[(long long)s * m + i];
    sbl[i] = sg * blv;
    sbu[i] = sg * buv;
  }

  // owned rows: box rows [r0, r0 + nrow), or the layout's list (box rows
  // first, then the rows of the owned SOC blocks)
  int r0 = 0, nrow, nbox;
  const int* rl = nullptr;
  if constexpr (CONES) {
    const int* L = sp.layout;       // row_ptr (P+1), box_cnt (P),
    nrow = L[b + 1] - L[b];         // cone_ptr (P+1), rows (m), cones
    nbox = L[P + 1 + b];
    rl = L + 3 * P + 2 + L[b];
  } else {
    r0 = (int)((long long)b * m / P);
    nrow = (int)((long long)(b + 1) * m / P) - r0;
    nbox = nrow;
  }
  auto row_at = [&](int k) -> int { return CONES ? rl[k] : r0 + k; };

  // A'y: thread (rg, cc) sums rows rg, rg + R, ... of column cc
  const int cw = w < kThreads ? w : kThreads;
  const int R = cw > 0 ? min(kThreads / cw, kMaxRowGroups) : 0;
  const int rg = cw > 0 ? tid / cw : 0;
  const int cc = tid - rg * cw;
  float* my_part = sp.part + ((long long)s * P + b) * m;
  const float* part_s = sp.part + (long long)s * P * m;
  float* yo_s = g.yo + (long long)s * m;
  const unsigned blocks = gridDim.x;
  int G = 1;                      // lanes a row in the dual half
  while (G < 32 && G < P) G <<= 1;
  const int rpw = 32 / G;
  __syncthreads();

  for (int it = 0; it < g.n_iters; ++it) {
    // ---- stage y (every block's rows of the last dual half) ----
    if (it > 0) {
      for (int i = tid; i < m; i += kThreads) y[i] = __ldcg(yo_s + i);
    }
    if (MODE != MODE_F32) {
      for (int i = tid; i < m; i += kThreads) {
        const float v = y[i];
        const float hi = bf16_round(v);
        yh[i] = hi;
        yl[i] = MODE == MODE_BF16X3 ? bf16_round(v - hi) : 0.f;
      }
    }
    __syncthreads();
    // ---- primal half: A[:, J]'y, the box prox, v ----
    for (int base = 0; base < w; base += cw) {
      const int jj = base + cc;
      const bool mine = rg < R && jj < w;
      float acc = 0.f;
      if (mine) {
        for (int i = rg; i < m; i += R) {
          const float vh_i = MODE == MODE_F32 ? y[i] : yh[i];
          const float vl_i = MODE == MODE_BF16X3 ? yl[i] : 0.f;
          acc = mac<MODE>(acc, a_hi(i, jj), a_lo(i, jj), vh_i, vl_i);
        }
      }
      if (R > 1) {  // one pass only (w <= kThreads)
        if (rg < R) red[tid] = acc;
        __syncthreads();
        if (rg == 0 && jj < w)
          for (int q = 1; q < R; ++q) acc += red[q * cw + cc];
      }
      if (rg == 0 && jj < w) {
        const float xv = x[jj];
        float x1 = xv - t * acc;
        x1 = (x1 - tc[jj]) * pre[jj];
        x1 = frozen ? xv : clip(x1, lo[jj], up[jj]);
        x[jj] = x1;
        xs[jj] += x1;
        const float v = 2.0f * x1 - xv;
        if (MODE == MODE_F32) {
          vh[jj] = v;
        } else {
          const float hi = bf16_round(v);
          vh[jj] = hi;
          vl[jj] = MODE == MODE_BF16X3 ? bf16_round(v - hi) : 0.f;
        }
      }
    }
    __syncthreads();
    // ---- the slab's partial A v, one thread per row ----
    for (int i = tid; i < m; i += kThreads) {
      float acc = 0.f;
      for (int jj = 0; jj < w; ++jj)
        acc = mac<MODE>(acc, a_hi(i, jj), a_lo(i, jj), vh[jj],
                        MODE == MODE_BF16X3 ? vl[jj] : 0.f);
      my_part[i] = acc;
    }
    grid_sync(sp.bar, blocks);
    // ---- dual half: the owned rows' A v, the box-row prox or w; a row
    //      takes G lanes of a warp (P's partials in lane order, then a
    //      butterfly), 32 / G rows a warp at once ----
    for (int k0 = warp * rpw; k0 < nrow; k0 += kWarps * rpw) {
      const int k = k0 + lane / G;
      const bool have = k < nrow;
      const int i = have ? row_at(k) : 0;
      float acc = 0.f;
      if (have)
        for (int p = lane % G; p < P; p += G)
          acc += __ldcg(part_s + (long long)p * m + i);
      for (int off = G >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (have && lane % G == 0) {
        const float wi = y[i] + sg * acc;
        if (CONES && k >= nbox) {
          wv[i] = wi;
        } else {
          const float y1 = frozen ? y[i] : wi - clip(wi, sbl[i], sbu[i]);
          y[i] = y1;
          ys[i] += y1;
          yo_s[i] = y1;
        }
      }
    }
    // ---- cone step: one thread per owned SOC block ----
    if constexpr (CONES) {
      __syncthreads();
      const int* L = sp.layout;
      const int* cones = L + 3 * P + 2 + m;
      for (int q = L[2 * P + 1 + b] + tid; q < L[2 * P + 2 + b];
           q += kThreads) {
        const int k = cones[q];
        soc_block(g.cone_rows + g.cone_ptr[k],
                  g.cone_ptr[k + 1] - g.cone_ptr[k], 1, frozen, wv, sbl, y,
                  ys);
      }
      __syncthreads();
      for (int k = nbox + tid; k < nrow; k += kThreads) {
        const int i = rl[k];
        yo_s[i] = y[i];
      }
    }
    if (it + 1 < g.n_iters) grid_sync(sp.bar, blocks);
  }
  __syncthreads();

  // ---- write back the owned columns and rows ----
  for (int jj = tid; jj < w; jj += kThreads) {
    g.xo[(long long)s * n + c0 + jj] = x[jj];
    g.xso[(long long)s * n + c0 + jj] = xs[jj];
  }
  for (int k = tid; k < nrow; k += kThreads) {
    const int i = row_at(k);
    yo_s[i] = y[i];
    g.yso[(long long)s * m + i] = ys[i];
  }
  grid_done(sp.bar, blocks);
}

template <int MODE, bool CONES, bool RES>
cudaError_t launch(const Args& g, const Split& sp, cudaStream_t stream) {
  const size_t bytes = split_smem_bytes(MODE, g.m, g.n, sp.P, CONES, RES);
  const void* kern = (const void*)pdhg_window_split<MODE, CONES, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((long long)g.S * sp.P > (long long)per_sm * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  Args ga = g;
  Split sa = sp;
  void* params[] = {&ga, &sa};
  err = cudaLaunchCooperativeKernel(kern, dim3(g.S * sp.P), dim3(kThreads),
                                    params, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_kind(const Args& g, const Split& sp, bool res,
                          cudaStream_t st) {
  if (g.num_cones > 0)
    return res ? launch<MODE, true, true>(g, sp, st)
               : launch<MODE, true, false>(g, sp, st);
  return res ? launch<MODE, false, true>(g, sp, st)
             : launch<MODE, false, false>(g, sp, st);
}

}  // namespace

cudaError_t launch_split(const Args& g, int mode, int P, bool res,
                         float* part, unsigned* bar, const int* layout,
                         cudaStream_t st) {
  if (P <= 0 || part == nullptr || bar == nullptr ||
      (g.num_cones > 0 && layout == nullptr) || g.d_row != nullptr)
    return cudaErrorInvalidValue;
  const Split sp{P, part, bar, layout};
  switch (mode) {
    case MODE_F32: return dispatch_kind<MODE_F32>(g, sp, res, st);
    case MODE_BF16: return dispatch_kind<MODE_BF16>(g, sp, res, st);
    case MODE_BF16X3:
      if (g.A_lo == nullptr) return cudaErrorInvalidValue;
      return dispatch_kind<MODE_BF16X3>(g, sp, res, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pdhg

// The split design's shared memory for a shape (ops/pdhg_window.py::
// split_smem_bytes computes the same number).
extern "C" long long pdhg_window_split_bytes(int mode, int m, int n, int P,
                                             int cones, int res) {
  return (long long)pdhg::split_smem_bytes(mode, m, n, P, cones != 0,
                                           res != 0);
}
