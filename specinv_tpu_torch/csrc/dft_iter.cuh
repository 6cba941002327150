// The direct-DFT iteration engine shared by gl_fused.cu and admm_fused.cu:
// one iteration is three launches, the forward DFT with the algorithm's
// middle in its epilogue, the inverse DFT, and fullrun.cuh's ola_kernel.
//
// The DFT is a pair of matrix products against cos/sin tables (ops/dft.py,
// the counterpart of gl_fused._dft_tables): for each clip b,
//
//   S      = frames @ C  -  i * frames @ Sn       frames (T, n), C/Sn (n, F)
//   frames = window * (P_re @ C^T - P_im @ Sn^T)  P (T, F), Hermitian fold
//                                                 weights w folded into P
//
// where frames[t, k] = x_pad[b, t*hop + k] * window[k] is built from the
// signal while a tile is loaded (no frames tensor in the forward).  Each
// product runs in one of the precision schemes of gl_fused.py:101-164:
//
//   kDefault   ah*bh                        one bf16 tensor-core pass
//   kHigh      ah*bh + ah*bl + al*bh        three passes (JAX HIGH)
//   kBf16x2    ah*bh + ah*bl                two passes, table low bits
//   kBf16x2t   ah*bh + al*bh                two passes, data low bits
//   kHighest   float32 on the CUDA cores
//
// with hi = bf16_rn(x), lo = bf16_rn(x - hi) (JAX's astype rounding).  The
// data operand (frames, P) is split while its tile is loaded; the tables
// come pre-split from the wrapper's device cache.  Each pass has its own
// float32 accumulator and the passes are added in JAX's order, (hh + hl) +
// lh, when the tile is finished.
//
// Layout: a block computes a 64 x 64 output tile of one clip (rows are
// frames; columns are bins in the forward and samples in the inverse) with
// 8 warps, each 16 rows x 32 columns as two 16x16x16 bf16 WMMA fragments
// per pass and per operand half.  Tiles of 32 along the contraction are
// loaded into shared memory with masks (zeros past T, F or n_fft), so no
// shape needs to be a multiple of anything; the result goes through shared
// memory to the epilogue (the fragment layout is opaque), which never
// stores past T, F or n_fft.
//
// A Middle is a functor with
//   __device__ float2 operator()(float2 s, float2& state, float tgt, float w,
//                                bool valid) const;
// where s is the forward bin (re, im), state the bin's state (read from
// state_in, then written to state_out, which may be the same buffer), tgt
// the target magnitude, w the bin's fold weight and valid whether the frame
// lies below valid_t; it returns the bin of P.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "fullrun.cuh"

namespace specinv {
namespace {

// The order of ops/dft.py SCHEMES.
enum Scheme { kDefault = 0, kHigh = 1, kHighest = 2, kBf16x2 = 3, kBf16x2t = 4 };

template <int S>
struct SchemeTraits {
  static constexpr bool kBLo = S == kHigh || S == kBf16x2;   // the ah*bl pass
  static constexpr bool kALo = S == kHigh || S == kBf16x2t;  // the al*bh pass
};

constexpr int kBM = 64;          // rows (frames) per tile
constexpr int kBN = 64;          // columns (bins or samples) per tile
constexpr int kBK = 32;          // contraction per shared-memory tile
constexpr int kThreads = 256;    // 8 warps
constexpr int kLdA = kBK + 8;    // bf16 row-major data tile
constexpr int kLdB = kBN + 8;    // bf16 row-major table tile (forward)
constexpr int kLdBt = kBK + 8;   // bf16 column-major table tile (inverse)
constexpr int kLdO = kBN + 4;    // float32 result tile
constexpr int kLdP = kBM + 1;    // float32 transposed tiles (HIGHEST)

using bf16 = __nv_bfloat16;
using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                     nvcuda::wmma::row_major>;
using FragAcc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

constexpr int kFwdSmem = 2 * kBM * kLdO * 4;  // the two result tiles, the largest use
constexpr int kInvSmem = 4 * kBM * kLdA * 2 + 4 * kBN * kLdBt * 2;

// Per-table device pointers; the bf16 halves of the tables are (n, F)
// row-major like the float32 ones, and lo may be null where no scheme of
// the call reads it.
struct Tables {
  const float* cos;
  const float* sin;
  const bf16* cos_hi;
  const bf16* cos_lo;
  const bf16* sin_hi;
  const bf16* sin_lo;
};

__device__ __forceinline__ void split_bf16(float v, bf16* hi, bf16* lo, int i) {
  const bf16 h = __float2bfloat16_rn(v);
  hi[i] = h;
  if (lo != nullptr) lo[i] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
}

// (hh + hl) + lh of one fragment's passes, in JAX's order.
template <int S>
__device__ __forceinline__ void sum_passes(FragAcc& out, const FragAcc (&p)[3]) {
  out = p[0];
  if constexpr (SchemeTraits<S>::kBLo) {
    for (int e = 0; e < out.num_elements; ++e) out.x[e] = __fadd_rn(out.x[e], p[1].x[e]);
  }
  if constexpr (SchemeTraits<S>::kALo) {
    for (int e = 0; e < out.num_elements; ++e) out.x[e] = __fadd_rn(out.x[e], p[2].x[e]);
  }
}

// Forward product of one tile on the tensor cores: stage_re / stage_im
// (kBM x kLdO) get frames @ C and frames @ Sn.
template <int S>
__device__ void forward_bf16(unsigned char* smem, const float* __restrict__ xb,
                             const float* __restrict__ window, const Tables tab,
                             int t0, int f0, int T, int n, int hop, int n_bins,
                             float* stage_re, float* stage_im) {
  using namespace nvcuda;
  constexpr bool kALo = SchemeTraits<S>::kALo, kBLo = SchemeTraits<S>::kBLo;
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = a_hi + kBM * kLdA;
  bf16* c_hi = a_lo + kBM * kLdA;
  bf16* c_lo = c_hi + kBK * kLdB;
  bf16* s_hi = c_lo + kBK * kLdB;
  bf16* s_lo = s_hi + kBK * kLdB;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  FragAcc re[2][3], im[2][3];  // [column fragment][pass: hh, hl, lh]
  for (int j = 0; j < 2; ++j) {
    for (int p = 0; p < 3; ++p) {
      wmma::fill_fragment(re[j][p], 0.0f);
      wmma::fill_fragment(im[j][p], 0.0f);
    }
  }
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int k0 = 0; k0 < n; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK, t = t0 + r, kk = k0 + k;
      const float v = (t < T && kk < n)
                          ? __fmul_rn(xb[static_cast<size_t>(t) * hop + kk], window[kk])
                          : 0.0f;
      split_bf16(v, a_hi, kALo ? a_lo : nullptr, r * kLdA + k);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, c = i % kBN, kk = k0 + k, f = f0 + c;
      const bool in = kk < n && f < n_bins;
      const size_t g = static_cast<size_t>(kk) * n_bins + f;
      c_hi[k * kLdB + c] = in ? tab.cos_hi[g] : zero;
      s_hi[k * kLdB + c] = in ? tab.sin_hi[g] : zero;
      if constexpr (kBLo) {
        c_lo[k * kLdB + c] = in ? tab.cos_lo[g] : zero;
        s_lo[k * kLdB + c] = in ? tab.sin_lo[g] : zero;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA ah, al;
      wmma::load_matrix_sync(ah, a_hi + wm * 16 * kLdA + kk, kLdA);
      if constexpr (kALo) wmma::load_matrix_sync(al, a_lo + wm * 16 * kLdA + kk, kLdA);
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bh, bl;
        // real part: frames @ C
        wmma::load_matrix_sync(bh, c_hi + kk * kLdB + col, kLdB);
        wmma::mma_sync(re[j][0], ah, bh, re[j][0]);
        if constexpr (kALo) wmma::mma_sync(re[j][2], al, bh, re[j][2]);
        if constexpr (kBLo) {
          wmma::load_matrix_sync(bl, c_lo + kk * kLdB + col, kLdB);
          wmma::mma_sync(re[j][1], ah, bl, re[j][1]);
        }
        // imaginary part (before its sign): frames @ Sn
        wmma::load_matrix_sync(bh, s_hi + kk * kLdB + col, kLdB);
        wmma::mma_sync(im[j][0], ah, bh, im[j][0]);
        if constexpr (kALo) wmma::mma_sync(im[j][2], al, bh, im[j][2]);
        if constexpr (kBLo) {
          wmma::load_matrix_sync(bl, s_lo + kk * kLdB + col, kLdB);
          wmma::mma_sync(im[j][1], ah, bl, im[j][1]);
        }
      }
    }
    __syncthreads();
  }
  for (int j = 0; j < 2; ++j) {
    FragAcc out;
    const int at = wm * 16 * kLdO + wn * 32 + j * 16;
    sum_passes<S>(out, re[j]);
    wmma::store_matrix_sync(stage_re + at, out, kLdO, wmma::mem_row_major);
    sum_passes<S>(out, im[j]);
    wmma::store_matrix_sync(stage_im + at, out, kLdO, wmma::mem_row_major);
  }
}

// The same product in float32 on the CUDA cores (HIGHEST): each thread
// owns 4 rows x 4 columns of both results.
__device__ void forward_f32(unsigned char* smem, const float* __restrict__ xb,
                            const float* __restrict__ window, const Tables tab,
                            int t0, int f0, int T, int n, int hop, int n_bins,
                            float* stage_re, float* stage_im) {
  float* a = reinterpret_cast<float*>(smem);  // [kBK][kLdP], transposed
  float* c = a + kBK * kLdP;                  // [kBK][kBN]
  float* s = c + kBK * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc_re[4][4] = {}, acc_im[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK, t = t0 + r, kk = k0 + k;
      a[k * kLdP + r] = (t < T && kk < n)
                            ? __fmul_rn(xb[static_cast<size_t>(t) * hop + kk], window[kk])
                            : 0.0f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, col = i % kBN, kk = k0 + k, f = f0 + col;
      const bool in = kk < n && f < n_bins;
      const size_t g = static_cast<size_t>(kk) * n_bins + f;
      c[i] = in ? tab.cos[g] : 0.0f;
      s[i] = in ? tab.sin[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float av[4], cv[4], sv[4];
      for (int i = 0; i < 4; ++i) av[i] = a[k * kLdP + ty * 4 + i];
      for (int j = 0; j < 4; ++j) {
        cv[j] = c[k * kBN + tx * 4 + j];
        sv[j] = s[k * kBN + tx * 4 + j];
      }
      for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = fmaf(av[i], cv[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(av[i], sv[j], acc_im[i][j]);
        }
      }
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      stage_re[(ty * 4 + i) * kLdO + tx * 4 + j] = acc_re[i][j];
      stage_im[(ty * 4 + i) * kLdO + tx * 4 + j] = acc_im[i][j];
    }
  }
}

// Forward DFT of a 64-frame x 64-bin tile of clip blockIdx.z, then for each
// bin: mag = |S| (if requested), the Middle (state updated in place), and
// P written to spec for the inverse.
template <int S, class Middle>
__global__ void __launch_bounds__(kThreads) dft_forward_kernel(
    const float* __restrict__ x_pad,     // (B, lp)
    const float2* state_in,              // (B, T, F)
    float2* state_out,                   // (B, T, F), may be state_in
    const float* __restrict__ target,    // (B, T, F)
    const float* __restrict__ window,    // (n)
    const float* __restrict__ wts,       // (F) fold weights * iscale / fscale
    const Tables tab,
    float2* __restrict__ spec,           // (B, T, F) P out
    float* __restrict__ mag,             // (B, T, F) or null
    int T, int n, int hop, int n_bins, int lp, int valid_t, Middle middle) {
  __shared__ __align__(128) unsigned char smem[kFwdSmem];
  float* stage_re = reinterpret_cast<float*>(smem);
  float* stage_im = stage_re + kBM * kLdO;
  const int f0 = blockIdx.x * kBN, t0 = blockIdx.y * kBM, b = blockIdx.z;
  const float* xb = x_pad + static_cast<size_t>(b) * lp;
  if constexpr (S == kHighest) {
    forward_f32(smem, xb, window, tab, t0, f0, T, n, hop, n_bins, stage_re, stage_im);
  } else {
    forward_bf16<S>(smem, xb, window, tab, t0, f0, T, n, hop, n_bins, stage_re, stage_im);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN, t = t0 + r, f = f0 + c;
    if (t >= T || f >= n_bins) continue;
    const size_t idx = (static_cast<size_t>(b) * T + t) * n_bins + f;
    const float2 s = make_float2(stage_re[r * kLdO + c], -stage_im[r * kLdO + c]);
    // Rounded products and sums (never contracted into an FMA), so the
    // state does not depend on whether mag is written.
    if (mag != nullptr) {
      mag[idx] = __fsqrt_rn(__fadd_rn(__fmul_rn(s.x, s.x), __fmul_rn(s.y, s.y)));
    }
    float2 st = state_in[idx];
    spec[idx] = middle(s, st, target[idx], wts[f], t < valid_t);
    state_out[idx] = st;
  }
}

// Inverse product of one tile on the tensor cores: stage (kBM x kLdO) gets
// P_re @ C^T - P_im @ Sn^T.  The table tiles are read transposed: a
// column-major tile of C^T is a row-major tile of C.
template <int S>
__device__ void inverse_bf16(unsigned char* smem, const float2* __restrict__ pb,
                             const Tables tab, int t0, int j0, int T, int n,
                             int n_bins, float* stage) {
  using namespace nvcuda;
  constexpr bool kALo = SchemeTraits<S>::kALo, kBLo = SchemeTraits<S>::kBLo;
  bf16* re_hi = reinterpret_cast<bf16*>(smem);
  bf16* re_lo = re_hi + kBM * kLdA;
  bf16* im_hi = re_lo + kBM * kLdA;
  bf16* im_lo = im_hi + kBM * kLdA;
  bf16* c_hi = im_lo + kBM * kLdA;  // [kBN][kLdBt]: element (k, j) at j*kLdBt + k
  bf16* c_lo = c_hi + kBN * kLdBt;
  bf16* s_hi = c_lo + kBN * kLdBt;
  bf16* s_lo = s_hi + kBN * kLdBt;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  FragAcc dre[2][3], dim[2][3];
  for (int j = 0; j < 2; ++j) {
    for (int p = 0; p < 3; ++p) {
      wmma::fill_fragment(dre[j][p], 0.0f);
      wmma::fill_fragment(dim[j][p], 0.0f);
    }
  }
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int k0 = 0; k0 < n_bins; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK, t = t0 + r, kk = k0 + k;
      const float2 v = (t < T && kk < n_bins) ? pb[static_cast<size_t>(t) * n_bins + kk]
                                              : make_float2(0.0f, 0.0f);
      split_bf16(v.x, re_hi, kALo ? re_lo : nullptr, r * kLdA + k);
      split_bf16(v.y, im_hi, kALo ? im_lo : nullptr, r * kLdA + k);
    }
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int j = i / kBK, k = i % kBK, jj = j0 + j, kk = k0 + k;
      const bool in = jj < n && kk < n_bins;
      const size_t g = static_cast<size_t>(jj) * n_bins + kk;
      c_hi[j * kLdBt + k] = in ? tab.cos_hi[g] : zero;
      s_hi[j * kLdBt + k] = in ? tab.sin_hi[g] : zero;
      if constexpr (kBLo) {
        c_lo[j * kLdBt + k] = in ? tab.cos_lo[g] : zero;
        s_lo[j * kLdBt + k] = in ? tab.sin_lo[g] : zero;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA rh, rl, ih, il;
      wmma::load_matrix_sync(rh, re_hi + wm * 16 * kLdA + kk, kLdA);
      wmma::load_matrix_sync(ih, im_hi + wm * 16 * kLdA + kk, kLdA);
      if constexpr (kALo) {
        wmma::load_matrix_sync(rl, re_lo + wm * 16 * kLdA + kk, kLdA);
        wmma::load_matrix_sync(il, im_lo + wm * 16 * kLdA + kk, kLdA);
      }
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bh, bl;
        wmma::load_matrix_sync(bh, c_hi + col * kLdBt + kk, kLdBt);
        wmma::mma_sync(dre[j][0], rh, bh, dre[j][0]);
        if constexpr (kALo) wmma::mma_sync(dre[j][2], rl, bh, dre[j][2]);
        if constexpr (kBLo) {
          wmma::load_matrix_sync(bl, c_lo + col * kLdBt + kk, kLdBt);
          wmma::mma_sync(dre[j][1], rh, bl, dre[j][1]);
        }
        wmma::load_matrix_sync(bh, s_hi + col * kLdBt + kk, kLdBt);
        wmma::mma_sync(dim[j][0], ih, bh, dim[j][0]);
        if constexpr (kALo) wmma::mma_sync(dim[j][2], il, bh, dim[j][2]);
        if constexpr (kBLo) {
          wmma::load_matrix_sync(bl, s_lo + col * kLdBt + kk, kLdBt);
          wmma::mma_sync(dim[j][1], ih, bl, dim[j][1]);
        }
      }
    }
    __syncthreads();
  }
  for (int j = 0; j < 2; ++j) {
    FragAcc a, b;
    sum_passes<S>(a, dre[j]);
    sum_passes<S>(b, dim[j]);
    for (int e = 0; e < a.num_elements; ++e) a.x[e] = __fsub_rn(a.x[e], b.x[e]);
    wmma::store_matrix_sync(stage + wm * 16 * kLdO + wn * 32 + j * 16, a, kLdO,
                            wmma::mem_row_major);
  }
}

// The inverse product in float32 on the CUDA cores (HIGHEST).
__device__ void inverse_f32(unsigned char* smem, const float2* __restrict__ pb,
                            const Tables tab, int t0, int j0, int T, int n,
                            int n_bins, float* stage) {
  float* are = reinterpret_cast<float*>(smem);  // [kBK][kLdP], transposed
  float* aim = are + kBK * kLdP;
  float* c = aim + kBK * kLdP;                   // [kBK][kLdP]: (k, j) at k*kLdP + j
  float* s = c + kBK * kLdP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc_re[4][4] = {}, acc_im[4][4] = {};
  for (int k0 = 0; k0 < n_bins; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK, t = t0 + r, kk = k0 + k;
      const float2 v = (t < T && kk < n_bins) ? pb[static_cast<size_t>(t) * n_bins + kk]
                                              : make_float2(0.0f, 0.0f);
      are[k * kLdP + r] = v.x;
      aim[k * kLdP + r] = v.y;
    }
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int j = i / kBK, k = i % kBK, jj = j0 + j, kk = k0 + k;
      const bool in = jj < n && kk < n_bins;
      const size_t g = static_cast<size_t>(jj) * n_bins + kk;
      c[k * kLdP + j] = in ? tab.cos[g] : 0.0f;
      s[k * kLdP + j] = in ? tab.sin[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float rv[4], iv[4], cv[4], sv[4];
      for (int i = 0; i < 4; ++i) {
        rv[i] = are[k * kLdP + ty * 4 + i];
        iv[i] = aim[k * kLdP + ty * 4 + i];
      }
      for (int j = 0; j < 4; ++j) {
        cv[j] = c[k * kLdP + tx * 4 + j];
        sv[j] = s[k * kLdP + tx * 4 + j];
      }
      for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = fmaf(rv[i], cv[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(iv[i], sv[j], acc_im[i][j]);
        }
      }
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      stage[(ty * 4 + i) * kLdO + tx * 4 + j] = __fsub_rn(acc_re[i][j], acc_im[i][j]);
    }
  }
}

// Inverse DFT of a 64-frame x 64-sample tile of clip blockIdx.z, times the
// window, into the (B, T, n) frame scratch that ola_kernel reads.
template <int S>
__global__ void __launch_bounds__(kThreads) dft_inverse_kernel(
    const float2* __restrict__ spec,     // (B, T, F) P
    const float* __restrict__ window,    // (n)
    const Tables tab,
    float* __restrict__ frames,          // (B, T, n)
    int T, int n, int n_bins) {
  __shared__ __align__(128) unsigned char smem[kInvSmem];
  float* stage = reinterpret_cast<float*>(smem);
  const int j0 = blockIdx.x * kBN, t0 = blockIdx.y * kBM, b = blockIdx.z;
  const float2* pb = spec + static_cast<size_t>(b) * T * n_bins;
  if constexpr (S == kHighest) {
    inverse_f32(smem, pb, tab, t0, j0, T, n, n_bins, stage);
  } else {
    inverse_bf16<S>(smem, pb, tab, t0, j0, T, n, n_bins, stage);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN, t = t0 + r, j = j0 + c;
    if (t < T && j < n) {
      frames[(static_cast<size_t>(b) * T + t) * n + j] = __fmul_rn(stage[r * kLdO + c], window[j]);
    }
  }
}

static_assert(kBK * kLdP * 4 + 2 * kBK * kBN * 4 <= kFwdSmem, "forward_f32 tiles");
static_assert(2 * kBM * kLdA * 2 + 4 * kBK * kLdB * 2 <= kFwdSmem, "forward_bf16 tiles");
static_assert(4 * kBK * kLdP * 4 <= kInvSmem, "inverse_f32 tiles");
static_assert(kBM * kLdO * 4 <= kInvSmem, "inverse result tile");

// Calls f(std::integral_constant<int, S>) for the scheme code s; false if
// s is no scheme.
template <class F>
bool with_scheme(int s, F&& f) {
  switch (s) {
    case kDefault: f(std::integral_constant<int, kDefault>{}); return true;
    case kHigh: f(std::integral_constant<int, kHigh>{}); return true;
    case kHighest: f(std::integral_constant<int, kHighest>{}); return true;
    case kBf16x2: f(std::integral_constant<int, kBf16x2>{}); return true;
    case kBf16x2t: f(std::integral_constant<int, kBf16x2t>{}); return true;
    default: return false;
  }
}

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

// One iteration: x_in -> x_out (distinct buffers), state_in -> state_out
// (may be one buffer), spec (B, T, F) and frames (B, T, n) scratch, mag may
// be null.  Returns the first launch error (0 if none).
template <class Middle>
int run_dft_iteration(const float* x_in, float* x_out, const float2* state_in,
                      float2* state_out, const float* target, const float* window,
                      const float* wts, const Tables tab, const float* inv_env,
                      float2* spec, float* frames, float* mag, int B, int T,
                      int n, int hop, int n_bins, int lp, int p_amt, int e,
                      int pad_mode, int fwd_scheme, int inv_scheme,
                      int valid_t, Middle middle, cudaStream_t stream) {
  const dim3 fwd_grid(cdiv(n_bins, kBN), cdiv(T, kBM), B);
  const bool fwd_ok = with_scheme(fwd_scheme, [&](auto s) {
    dft_forward_kernel<decltype(s)::value, Middle><<<fwd_grid, kThreads, 0, stream>>>(
        x_in, state_in, state_out, target, window, wts, tab, spec, mag, T, n, hop,
        n_bins, lp, valid_t, middle);
  });
  if (!fwd_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 inv_grid(cdiv(n, kBN), cdiv(T, kBM), B);
  const bool inv_ok = with_scheme(inv_scheme, [&](auto s) {
    dft_inverse_kernel<decltype(s)::value><<<inv_grid, kThreads, 0, stream>>>(
        spec, window, tab, frames, T, n, n_bins);
  });
  if (!inv_ok) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const size_t total = static_cast<size_t>(B) * lp;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  ola_kernel<<<blocks, threads, 0, stream>>>(frames, inv_env, x_out, B, T, n, hop, lp,
                                             p_amt, e, pad_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace specinv
