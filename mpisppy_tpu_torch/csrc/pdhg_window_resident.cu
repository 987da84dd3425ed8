// The PDHG restart window with A resident in shared memory: the same
// function as the streamed kernel in pdhg_window.cu (box rows, and SYNTH
// draws in the load phase), redesigned for Hopper.
//
// Replaces mpisppy_tpu/ops/pdhg_pallas.py::run_window for box and synth
// batches whose A fits: _tile_math (:116), _window_kernel (:227) through
// pallas_call (:491), _run_window_pipelined through pallas_call (:663),
// and the bf16x3 split (_split_bf16 :68, _split_bf16_kernel :82, _dot3
// :93), with the Pallas engine's TileSynth load (:279-314, :624-629).
//
// What bounds it on an H100: each iteration is two matvec sweeps over A
// (A'y and A v, 4*m*n flops per scenario).  The streamed kernel re-read
// A from L2 twice per iteration for every 4 scenarios.  Here one
// persistent block per SM (256 threads) copies the packed A into shared
// memory once per launch (cp.async, 16 bytes a thread) and then walks
// tiles of T = 8 scenarios, so L2 sees A once per SM per window.  Every
// iteration then reads A from shared memory twice per tile, so each
// element read feeds T multiply-adds: in bf16x3 about 370 KB per
// tile-iteration (~2,900 cycles at 128 B a clock) and 1,080 mma.sync.
// What bounds it in practice is latency: the state below takes 250-255
// registers, so one block of 8 warps is all an SM holds, and little is
// left to hide shared-memory and tensor-core latency across the three
// barriers of an iteration.  The A'y loop is therefore straight-line
// code with no branch on the shape, so that its loads run ahead of the
// products (PERF.md has the times).  The per-scenario vectors never
// leave the SM during the window: x, its window sum, tau*c,
// 1/(1 + tau*q), l and u live in registers (24 (column, scenario) slots
// a thread), y, its window sum and sigma*bl, sigma*bu in registers of
// the dual step (2 (row, scenario) pairs a thread); shared memory holds
// A, the tile's y and v = 2x1 - x operands, and the partial sums of A v.
//
// bf16 and bf16x3 (MODE_BF16, MODE_BF16X3): both products on tensor
// cores, mma.sync m16n8k16 bf16 -> f32, with the tile's 8 scenarios as
// the N dimension.  A is packed by ops/pdhg_window.py as bf16 hi (and
// lo) planes padded to 16-row/16-column tiles, row stride n_pad + 8 so
// that ldmatrix's eight 16-byte rows fall on distinct banks.  A'y is
// A'(n_pad x m_pad) . Y(m_pad x 8): one row-major copy of A serves it
// through ldmatrix.trans; warp w owns column tiles w, w + 8, ... and its
// accumulator fragments are the thread's primal slots.  A v is
// A(m_pad x n_pad) . V(n_pad x 8): warp w owns row tile w % MT and a
// contiguous 1/KQ of the column tiles (MT*KQ <= 8); the KQ partial sums
// meet in shared memory and the dual step adds them in a fixed order.
// The three products are hi*hi, hi*lo and lo*hi (lo*lo dropped, as in
// _dot3); y and v are split with __float2bfloat16_rn as the streamed
// kernel does.  Tensor-core accumulation is f32 but does not round like
// a chain of IEEE adds; chip_smoke.py states the measured error.
//
// f32 (MODE_F32): IEEE fmaf on CUDA cores from shared memory (no TF32,
// no fast-math).  A is packed unpadded with an odd row stride.  A'y:
// thread t owns columns t, t + 256, t + 512 for all 8 scenarios, so each
// A element read feeds 8 FMAs against y broadcast from shared memory.
// A v: warp w owns 1/8 of the columns, lane r rows r and r + 32, again 8
// FMAs per A element against v broadcast; the 8 partial sums meet as
// above.
//
// Semantics as the streamed kernel: done lanes run with tau = sigma = 0,
// keep x and y bit for bit and keep accumulating their window sums;
// infinite row bounds are clipped to +-1e30 before sigma scales them;
// pad rows, columns and scenarios are zeros that stay zeros; shared
// (stride-0) c, q, l, u, bl and bu are read from their one row; every
// sum runs in a fixed order without atomics, so the kernel is
// deterministic, and SYNTH changes only the load of bl and bu.
//
// Layout limits (the design takes a shape only inside them; the shape
// rule in ops/pdhg_window.py sends the rest to the streamed kernel):
// m <= 64, n <= 768, and the layout's shared memory within the card's
// per-block limit.
#include "pdhg_window_common.cuh"

#include <cstdint>

namespace pdhg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;          // scenarios per tile: the n8 of m16n8k16
constexpr int kSlots = 24;     // primal (column, scenario) slots a thread
constexpr int kJT = 6;         // MMA modes: column tiles per warp
constexpr int kJC = 3;         // f32: columns per thread
constexpr int kMaxM = 64;      // dual step: (row, scenario) pairs, 2 a thread
constexpr int kMaxN = 768;     // = kWarps * kJT * 16 = kThreads * kJC
constexpr int kPS = 68;        // partial-sum stride per scenario (floats)

static_assert(kJT * 4 == kSlots && kJC * kT == kSlots, "slot layout");
static_assert(kMaxM * kT == 2 * kThreads, "pair layout");

struct Layout {
  int m_pad, n_pad, as;   // image rows, columns, row stride (elements)
  int vs, ys;             // MMA: V and Y row strides (bf16 elements)
  int mt, kq, nt;         // MMA: row tiles, column splits of A v, column
                          // tiles; f32: kq = column groups of A v
  int a_bytes, v_off, y_off, p_off, bytes;
};

inline int round_up(int v, int k) { return (v + k - 1) / k * k; }

bool make_layout(int mode, int m, int n, Layout& L) {
  if (m <= 0 || n <= 0 || m > kMaxM || n > kMaxN) return false;
  int v_bytes, y_bytes;
  if (mode == MODE_F32) {
    L.m_pad = m; L.n_pad = n; L.as = n | 1;
    L.vs = L.ys = 0;
    L.mt = L.nt = 0; L.kq = kWarps;
    L.a_bytes = round_up(m * L.as * 4, 16);
    v_bytes = n * kT * 4;
    y_bytes = m * kT * 4;
  } else if (mode == MODE_BF16 || mode == MODE_BF16X3) {
    const int planes = mode == MODE_BF16X3 ? 2 : 1;
    L.m_pad = round_up(m, 16); L.n_pad = round_up(n, 16);
    L.as = L.n_pad + 8; L.vs = L.as; L.ys = L.m_pad + 8;
    L.mt = L.m_pad / 16; L.kq = kWarps / L.mt; L.nt = L.n_pad / 16;
    L.a_bytes = planes * L.m_pad * L.as * 2;
    v_bytes = planes * kT * L.vs * 2;
    y_bytes = planes * kT * L.ys * 2;
  } else {
    return false;
  }
  L.v_off = L.a_bytes;
  L.y_off = L.v_off + round_up(v_bytes, 16);
  L.p_off = L.y_off + round_up(y_bytes, 16);
  L.bytes = L.p_off + L.kq * kT * kPS * 4;
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

__device__ __forceinline__ void ldsm_x4(unsigned (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&a)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float* d, const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// v = hi + lo, both bf16 (lo only in bf16x3)
template <int MODE>
__device__ __forceinline__ void split_store(__nv_bfloat16* hi_p,
                                            __nv_bfloat16* lo_p, float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  *hi_p = hi;
  if (MODE == MODE_BF16X3)
    *lo_p = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// One column tile of A v for the MMA modes: d[p] += A_p(rows) . V_p
template <int MODE>
__device__ __forceinline__ void av_step(float (&d)[3][4],
                                        const __nv_bfloat16* a_hi,
                                        const __nv_bfloat16* a_lo,
                                        const __nv_bfloat16* v_hi,
                                        const __nv_bfloat16* v_lo) {
  unsigned a[4], b[2];
  ldsm_x4(a, a_hi);
  b[0] = lds32(v_hi);
  b[1] = lds32(v_hi + 8);
  mma(d[0], a, b);
  if (MODE == MODE_BF16X3) {
    unsigned al[4], bl[2];
    bl[0] = lds32(v_lo);
    bl[1] = lds32(v_lo + 8);
    mma(d[1], a, bl);
    ldsm_x4(al, a_lo);
    mma(d[2], al, b);
  }
}

template <int MODE, bool SYNTH>
__global__ void __launch_bounds__(kThreads, 1)
pdhg_window_resident(Args g, Layout L) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ float tau_s[kT], sigma_s[kT];
  __shared__ int frozen_s[kT];
  __shared__ unsigned key_s[kT][2];
  constexpr bool MMA = MODE != MODE_F32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int m = g.m, n = g.n;

  // ---- A once per block: the packed image, 16 bytes a thread ----
  {
    const char* src = static_cast<const char*>(g.A_img);
    for (int k = tid; k < L.a_bytes / 16; k += kThreads)
      cp_async16(sm + 16 * k, src + 16 * k);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // V and Y start as zeros: pad columns and rows stay finite zeros
  for (int k = tid; k < (L.p_off - L.v_off) / 4; k += kThreads)
    reinterpret_cast<float*>(sm + L.v_off)[k] = 0.f;

  const __nv_bfloat16* Ah = reinterpret_cast<const __nv_bfloat16*>(sm);
  const __nv_bfloat16* Al = Ah + L.m_pad * L.as;
  __nv_bfloat16* Vh = reinterpret_cast<__nv_bfloat16*>(sm + L.v_off);
  __nv_bfloat16* Vl = Vh + kT * L.vs;
  __nv_bfloat16* Yh = reinterpret_cast<__nv_bfloat16*>(sm + L.y_off);
  __nv_bfloat16* Yl = Yh + kT * L.ys;
  const float* Af = reinterpret_cast<const float*>(sm);
  float* Vf = reinterpret_cast<float*>(sm + L.v_off);
  float* Yf = reinterpret_cast<float*>(sm + L.y_off);
  float* P = reinterpret_cast<float*>(sm + L.p_off);

  // slot q of this thread: (column, scenario in the tile)
  auto slot_j = [&](int q) {
    return MMA ? ((warp + kWarps * (q >> 2)) << 4) + grp +
                     (((q >> 1) & 1) << 3)
               : tid + kThreads * (q >> 3);
  };
  auto slot_s = [&](int q) { return MMA ? tig * 2 + (q & 1) : q & 7; };
  auto store_y = [&](int s, int i, float v) {
    if (MMA)
      split_store<MODE>(Yh + s * L.ys + i, Yl + s * L.ys + i, v);
    else
      Yf[i * kT + s] = v;
  };

  float xr[kSlots], xsr[kSlots], tcr[kSlots], prer[kSlots], lr[kSlots],
      ur[kSlots];
  float yr[2], ysr[2], sblr[2], sbur[2];
  const int tiles = (g.S + kT - 1) / kT;
  bool first = true;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s0 = tile * kT;
    // ---- load: per-scenario scalars, then the hoisted invariants ----
    if (tid < kT) {
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
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = slot_j(q), s = slot_s(q), sc = s0 + s;
      float xv = 0.f, xsv = 0.f, cv = 0.f, qv = 0.f, lv = 0.f, uv = 0.f;
      if (j < n && sc < g.S) {
        xv = g.x[(long long)sc * n + j];
        xsv = g.xs[(long long)sc * n + j];
        cv = g.c[sc * g.c_stride + j];
        qv = g.q[sc * g.q_stride + j];
        lv = g.l[sc * g.l_stride + j];
        uv = g.u[sc * g.u_stride + j];
      }
      const float t = tau_s[s];
      xr[q] = xv;
      xsr[q] = xsv;
      tcr[q] = t * cv;
      prer[q] = 1.0f / (1.0f + t * qv);
      lr[q] = lv;
      ur[q] = uv;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = tid + kThreads * r, s = p >> 6, i = p & 63;
      const int sc = s0 + s;
      float yv = 0.f, ysv = 0.f, blv = 0.f, buv = 0.f;
      if (i < m && sc < g.S) {
        yv = g.y[(long long)sc * m + i];
        ysv = g.ys[(long long)sc * m + i];
        row_bounds<SYNTH>(g, sc, i, key_s[s][0], key_s[s][1], blv, buv);
      }
      const float sg = sigma_s[s];
      yr[r] = yv;
      ysr[r] = ysv;
      sblr[r] = sg * blv;
      sbur[r] = sg * buv;
      if (i < m) store_y(s, i, yv);
    }
    if (first) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      first = false;
    }
    __syncthreads();

    for (int it = 0; it < g.n_iters; ++it) {
      // ---- A'y into the primal slots ----
      float acc[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) acc[q] = 0.f;
      if (MMA) {
        // Straight-line code (no branch on the shape, so loads run ahead
        // of the products): row tiles past m_pad get zero y fragments,
        // column tiles past n_pad recompute the last tile into slots whose
        // columns lie past n (their l = u = 0 clip them to 0, unwritten).
        unsigned bh[4][2], bo[4][2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const bool live = kk < L.mt;
          const int off = grp * L.ys + min(kk, L.mt - 1) * 16 + tig * 2;
          bh[kk][0] = live ? lds32(Yh + off) : 0u;
          bh[kk][1] = live ? lds32(Yh + off + 8) : 0u;
          if (MODE == MODE_BF16X3) {
            bo[kk][0] = live ? lds32(Yl + off) : 0u;
            bo[kk][1] = live ? lds32(Yl + off + 8) : 0u;
          }
        }
        const int arow = (lane & 7) + ((lane >> 4) << 3);
        const int acol = ((lane >> 3) & 1) << 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int k = 0; k < kJT; ++k) {
            const int jt = min(warp + kWarps * k, L.nt - 1);
            const int off =
                (min(kk, L.mt - 1) * 16 + arow) * L.as + jt * 16 + acol;
            unsigned a[4];
            ldsm_x4_trans(a, Ah + off);
            mma(&acc[4 * k], a, bh[kk]);
            if (MODE == MODE_BF16X3) {
              unsigned al[4];
              mma(&acc[4 * k], a, bo[kk]);
              ldsm_x4_trans(al, Al + off);
              mma(&acc[4 * k], al, bh[kk]);
            }
          }
        }
      } else {
        int jc[kJC];
#pragma unroll
        for (int c = 0; c < kJC; ++c) jc[c] = min(tid + kThreads * c, n - 1);
        const float4* Y4 = reinterpret_cast<const float4*>(Yf);
#pragma unroll 4
        for (int i = 0; i < m; ++i) {
          const float4 ya = Y4[2 * i], yb = Y4[2 * i + 1];
          const float* Ar = Af + i * L.as;
#pragma unroll
          for (int c = 0; c < kJC; ++c) {
            const float a = Ar[jc[c]];
            float* d = acc + kT * c;
            d[0] = fmaf(a, ya.x, d[0]); d[1] = fmaf(a, ya.y, d[1]);
            d[2] = fmaf(a, ya.z, d[2]); d[3] = fmaf(a, ya.w, d[3]);
            d[4] = fmaf(a, yb.x, d[4]); d[5] = fmaf(a, yb.y, d[5]);
            d[6] = fmaf(a, yb.z, d[6]); d[7] = fmaf(a, yb.w, d[7]);
          }
        }
      }
      // ---- primal step: the box prox; v = 2 x1 - x into acc ----
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int s = slot_s(q);
        const float xv = xr[q];
        float x1 = xv - tau_s[s] * acc[q];
        x1 = (x1 - tcr[q]) * prer[q];
        x1 = frozen_s[s] ? xv : clip(x1, lr[q], ur[q]);
        xr[q] = x1;
        xsr[q] += x1;
        acc[q] = 2.0f * x1 - xv;
      }
      if (MMA) {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int j = slot_j(q), s = slot_s(q);
          if (j < n) split_store<MODE>(Vh + s * L.vs + j, Vl + s * L.vs + j,
                                       acc[q]);
        }
      } else {
        float4* V4 = reinterpret_cast<float4*>(Vf);
#pragma unroll
        for (int c = 0; c < kJC; ++c) {
          const int j = tid + kThreads * c;
          const float* v = acc + kT * c;
          if (j < n) {
            V4[2 * j] = make_float4(v[0], v[1], v[2], v[3]);
            V4[2 * j + 1] = make_float4(v[4], v[5], v[6], v[7]);
          }
        }
      }
      __syncthreads();
      // ---- A v: partial sums into P[kq][s][i] ----
      if (MMA) {
        const int mt = warp % L.mt, kq = warp / L.mt;
        if (kq < L.kq) {
          const int kb = kq * L.nt / L.kq, ke = (kq + 1) * L.nt / L.kq;
          const int arow = mt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int acol = (lane >> 4) << 3;
          const __nv_bfloat16* ah = Ah + arow * L.as + acol;
          const __nv_bfloat16* al = Al + arow * L.as + acol;
          const int voff = grp * L.vs + tig * 2;
          float d0[3][4] = {}, d1[3][4] = {};
          int kt = kb;
#pragma unroll 4
          for (; kt + 1 < ke; kt += 2) {
            av_step<MODE>(d0, ah + kt * 16, al + kt * 16,
                          Vh + voff + kt * 16, Vl + voff + kt * 16);
            av_step<MODE>(d1, ah + kt * 16 + 16, al + kt * 16 + 16,
                          Vh + voff + kt * 16 + 16, Vl + voff + kt * 16 + 16);
          }
          if (kt < ke)
            av_step<MODE>(d0, ah + kt * 16, al + kt * 16,
                          Vh + voff + kt * 16, Vl + voff + kt * 16);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float v = d0[0][c] + d1[0][c];
            if (MODE == MODE_BF16X3)
              v += (d0[1][c] + d1[1][c]) + (d0[2][c] + d1[2][c]);
            const int s = tig * 2 + (c & 1);
            const int i = mt * 16 + grp + ((c >> 1) << 3);
            P[(kq * kT + s) * kPS + i] = v;
          }
        }
      } else {
        const int jb = warp * n / kWarps, je = (warp + 1) * n / kWarps;
        const int i0 = lane, i1 = lane + 32;
        const float* A0 = Af + min(i0, m - 1) * L.as;
        const float* A1 = Af + min(i1, m - 1) * L.as;
        const float4* V4 = reinterpret_cast<const float4*>(Vf);
        float e0[kT], e1[kT];
#pragma unroll
        for (int s = 0; s < kT; ++s) e0[s] = e1[s] = 0.f;
#pragma unroll 4
        for (int j = jb; j < je; ++j) {
          const float a0 = A0[j], a1 = A1[j];
          const float4 va = V4[2 * j], vb = V4[2 * j + 1];
          const float v[kT] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
          for (int s = 0; s < kT; ++s) {
            e0[s] = fmaf(a0, v[s], e0[s]);
            e1[s] = fmaf(a1, v[s], e1[s]);
          }
        }
#pragma unroll
        for (int s = 0; s < kT; ++s) {
          if (i0 < m) P[(warp * kT + s) * kPS + i0] = e0[s];
          if (i1 < m) P[(warp * kT + s) * kPS + i1] = e1[s];
        }
      }
      __syncthreads();
      // ---- dual step: the box-row prox on (row, scenario) pairs ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = tid + kThreads * r, s = p >> 6, i = p & 63;
        if (i < m) {
          float ax = P[s * kPS + i];
          for (int k = 1; k < L.kq; ++k) ax += P[(k * kT + s) * kPS + i];
          const float yv = yr[r];
          const float w = yv + sigma_s[s] * ax;
          const float y1 = frozen_s[s] ? yv : w - clip(w, sblr[r], sbur[r]);
          yr[r] = y1;
          ysr[r] += y1;
          store_y(s, i, y1);
        }
      }
      __syncthreads();
    }

    // ---- write back ----
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = slot_j(q), sc = s0 + slot_s(q);
      if (j < n && sc < g.S) {
        g.xo[(long long)sc * n + j] = xr[q];
        g.xso[(long long)sc * n + j] = xsr[q];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = tid + kThreads * r, i = p & 63, sc = s0 + (p >> 6);
      if (i < m && sc < g.S) {
        g.yo[(long long)sc * m + i] = yr[r];
        g.yso[(long long)sc * m + i] = ysr[r];
      }
    }
  }
  if (first) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MODE, bool SYNTH>
cudaError_t launch(const Args& g, const Layout& L, int blocks,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pdhg_window_resident<MODE, SYNTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  pdhg_window_resident<MODE, SYNTH><<<blocks, kThreads, L.bytes, stream>>>(
      g, L);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_kind(const Args& g, const Layout& L, int blocks,
                        cudaStream_t stream) {
  if (g.d_row != nullptr) return launch<MODE, true>(g, L, blocks, stream);
  return launch<MODE, false>(g, L, blocks, stream);
}

}  // namespace

size_t resident_smem_bytes(int mode, int m, int n) {
  Layout L;
  return make_layout(mode, m, n, L) ? (size_t)L.bytes : 0;
}

size_t resident_image_bytes(int mode, int m, int n) {
  Layout L;
  return make_layout(mode, m, n, L) ? (size_t)L.a_bytes : 0;
}

cudaError_t launch_resident(const Args& g, int mode, int blocks,
                            cudaStream_t stream) {
  Layout L;
  if (!make_layout(mode, g.m, g.n, L) || g.A_img == nullptr || blocks <= 0 ||
      g.num_cones > 0)
    return cudaErrorInvalidValue;
  switch (mode) {
    case MODE_F32: return launch_kind<MODE_F32>(g, L, blocks, stream);
    case MODE_BF16: return launch_kind<MODE_BF16>(g, L, blocks, stream);
    case MODE_BF16X3: return launch_kind<MODE_BF16X3>(g, L, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pdhg
