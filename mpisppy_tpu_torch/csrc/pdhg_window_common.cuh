// What the window kernels (pdhg_window.cu: the streamed body;
// pdhg_window_resident.cu: box rows with A resident in shared memory;
// pdhg_window_cones.cu: SOC blocks with A resident in shared memory)
// share: the argument block, the arithmetic modes and their
// multiply-add, the row-bound clip, the SOC dual prox and the in-kernel
// threefry draw of SYNTH.  See pdhg_window.cu for the iteration all of
// them compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pdhg {

constexpr float kBig = 1e30f;
constexpr float kTiny = 1e-30f;

enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_BF16X3 = 3 };

struct Args {
  const float* A;     // (m, n) row-major: A (f32) or its bf16 hi part
  const float* A_lo;  // (m, n) bf16 lo part (MODE_BF16X3 only)
  const void* A_img;  // resident design: the packed shared-memory image
  int m, n, S, n_iters;
  const float* tau;   // (S,)
  const float* sigma; // (S,)
  const float* done;  // (S,) 1.0 = frozen
  const float* c;  long long c_stride;   // scenario strides: 0 = shared
  const float* q;  long long q_stride;
  const float* l;  long long l_stride;
  const float* u;  long long u_stride;
  const float* bl; long long bl_stride;
  const float* bu; long long bu_stride;
  const int* cone_ptr;   // (num_cones + 1,) CSR offsets (CONES only)
  const int* cone_rows;  // (cone_nnz,) block rows, head first
  int num_cones, cone_nnz;
  const float* x; const float* y; const float* xs; const float* ys;
  float* xo; float* yo; float* xso; float* yso;
  // SYNTH only: the program's base key, index window and row rule
  unsigned key0, key1;
  int start, num_real;
  int draw_row0, draw_count;
  float draw_thr, draw_below, draw_above;
  int draw_bl, draw_bu;
  const float* d_row;  // (m,) row scaling of the drawn values
};

__device__ __forceinline__ unsigned rotl32(unsigned v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ void mix4(unsigned& x0, unsigned& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0) ^ x0;
  x0 += x1; x1 = rotl32(x1, r1) ^ x0;
  x0 += x1; x1 = rotl32(x1, r2) ^ x0;
  x0 += x1; x1 = rotl32(x1, r3) ^ x0;
}

// Threefry-2x32, 20 rounds (as jax.random): key (k0, k1), counter
// (x0, x1) -> (x0, x1) in place.
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned& x0, unsigned& x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// The key of scenario sc: fold_in(base_key, idx), pad rows cloning the
// last real scenario.
__device__ __forceinline__ void scenario_key(const Args& g, int sc,
                                             unsigned& k0, unsigned& k1) {
  k0 = 0u;
  k1 = (unsigned)(min(sc, g.num_real - 1) + g.start);
  threefry2x32(g.key0, g.key1, k0, k1);
}

// The drawn value of row j of a scenario with key (k0, k1).
__device__ __forceinline__ float draw_row(const Args& g, unsigned k0,
                                          unsigned k1, int j) {
  unsigned y0 = 0u, y1 = (unsigned)j;
  threefry2x32(k0, k1, y0, y1);
  const unsigned bits = y0 ^ y1;
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return u < g.draw_thr ? g.draw_below : g.draw_above;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// acc + a*v in the kernel's arithmetic on CUDA cores: f32 and bf16 one
// fmaf (bf16 operands already rounded), bf16x3 the three products
// hi*hi + hi*lo + lo*hi (a = A's hi part, a_lo its lo part)
template <int MODE>
__device__ __forceinline__ float mac(float acc, float a, float a_lo,
                                     float v_hi, float v_lo) {
  if (MODE == MODE_F32) return fmaf(a, v_hi, acc);
  if (MODE == MODE_BF16) return fmaf(a, v_hi, acc);
  acc = fmaf(a, v_hi, acc);
  acc = fmaf(a, v_lo, acc);
  return fmaf(a_lo, v_hi, acc);
}

// The SOC dual prox of one block of one scenario: y1 = Proj_polar(wsh)
// with wsh = w - sigma*b (sbl holds sigma*b on SOC rows).  rows[0] is
// the head; row r of the scenario lies at element r * stride of each
// vector (1 in the streamed layout, the tile's scenario count in the
// resident one).  Frozen lanes keep y and only accumulate it.  IEEE f32
// in every mode: __fmul_rn / __fadd_rn keep FMA contraction from
// changing the rounding.
__device__ __forceinline__ void soc_block(const int* rows, int dim,
                                          int stride, bool frozen,
                                          const float* w, const float* sbl,
                                          float* y, float* ys) {
  if (frozen) {
    for (int r = 0; r < dim; ++r) ys[rows[r] * stride] += y[rows[r] * stride];
    return;
  }
  const int head = rows[0] * stride;
  const float t = w[head] - sbl[head];
  float zsq = 0.f;
  for (int r = 1; r < dim; ++r) {
    const float v = w[rows[r] * stride] - sbl[rows[r] * stride];
    zsq = __fadd_rn(zsq, __fmul_rn(v, v));
  }
  const float znorm = sqrtf(zsq);
  const bool inside = znorm <= t;
  const bool polar = znorm <= -t;
  const float alpha = 0.5f * (t + znorm);
  const float scale =
      inside ? 1.f : (polar ? 0.f : alpha / fmaxf(znorm, kTiny));
  const float tnew = inside ? t : (polar ? 0.f : alpha);
  const float yh = t - tnew;
  y[head] = yh;
  ys[head] += yh;
  for (int r = 1; r < dim; ++r) {
    const int row = rows[r] * stride;
    const float v = w[row] - sbl[row];
    const float y1 = v - __fmul_rn(v, scale);
    y[row] = y1;
    ys[row] += y1;
  }
}

// Row i's bounds of scenario sc (valid), +-inf clipped to +-1e30; with
// SYNTH the drawn rows are threefry draws scaled by one __fmul_rn.
template <bool SYNTH>
__device__ __forceinline__ void row_bounds(const Args& g, int sc, int i,
                                           unsigned k0, unsigned k1,
                                           float& blv, float& buv) {
  blv = clip(g.bl[sc * g.bl_stride + i], -kBig, kBig);
  buv = clip(g.bu[sc * g.bu_stride + i], -kBig, kBig);
  const int j = i - g.draw_row0;
  if (SYNTH && j >= 0 && j < g.draw_count) {
    const float v = draw_row(g, k0, k1, j);
    const float scaled = clip(__fmul_rn(v, g.d_row[i]), -kBig, kBig);
    if (g.draw_bl) blv = scaled;
    if (g.draw_bu) buv = scaled;
  }
}

// The resident design (pdhg_window_resident.cu): its shared-memory
// footprint and the bytes of its packed A for (mode, m, n), 0 when the
// shape is outside its layout, and its launch.
// ops/pdhg_window.py::resident_layout computes the same numbers.
size_t resident_smem_bytes(int mode, int m, int n);
size_t resident_image_bytes(int mode, int m, int n);
cudaError_t launch_resident(const Args& g, int mode, int blocks,
                            cudaStream_t stream);

// The resident design for SOC batches (pdhg_window_cones.cu): the same
// numbers for (mode, m, n, scenarios per tile, the cone layout's ints),
// 0 outside its layout, and its launch in `blocks` persistent blocks;
// ops/pdhg_window.py::cone_layout computes the same numbers.
size_t cones_smem_bytes(int mode, int m, int n, int tile, int cone_ints);
size_t cones_image_bytes(int mode, int m, int n);
cudaError_t launch_cones(const Args& g, int mode, int tile, int blocks,
                         cudaStream_t stream);

// The split design (pdhg_window_split.cu): one problem's columns and rows
// over P blocks of a cooperative launch.  Its slab's bytes in shared
// memory (f32 values, or the bf16 hi (and lo) planes, each of (m, |J|max
// | 1) with |J|max = ceil(n / P), rounded to 16 bytes) and a block's
// whole dynamic shared memory: the slab when res, eight n-vectors of the
// widest slab, four m-vectors (y, its window sum, sigma*bl, sigma*bu),
// two more in the bf16 modes (y's hi and lo) and one with cones (w), and
// the A'y row groups' partial sums.  ops/pdhg_window.py::split_smem_bytes
// computes the same numbers.
constexpr int kSplitThreads = 256;

__host__ __device__ inline size_t split_slab_bytes(int mode, int m, int n,
                                                   int P) {
  const size_t as = (size_t)(((n + P - 1) / P) | 1);
  const size_t elem = mode == MODE_F32 ? 4 : 2;
  const size_t planes = mode == MODE_BF16X3 ? 2 : 1;
  return (planes * (size_t)m * as * elem + 15) / 16 * 16;
}

__host__ __device__ inline size_t split_smem_bytes(int mode, int m, int n,
                                                   int P, bool cones,
                                                   bool res) {
  const size_t W = (size_t)((n + P - 1) / P);
  const size_t mvecs = 4 + (mode == MODE_F32 ? 0 : 2) + (cones ? 1 : 0);
  return (res ? split_slab_bytes(mode, m, n, P) : 0) +
         sizeof(float) * (8 * W + mvecs * (size_t)m + kSplitThreads);
}

// Its launch: S x P blocks, A[:, J] in shared memory when res, `part` the
// (S, P, m) scratch, `bar` two zeroed words, `layout` the SOC row
// partition (ops/pdhg_window.py::split_rows; null without cones).
cudaError_t launch_split(const Args& g, int mode, int P, bool res,
                         float* part, unsigned* bar, const int* layout,
                         cudaStream_t stream);

}  // namespace pdhg
