// Device FFT for the port's kernels: radix-2 complex FFT in shared memory.
//
// Replaces the TPU four-step transform specinv_tpu/ops/pallas/fft4.py
// (fwd4_lane :322, inv4_real_lane :367, fwd4 :250, inv4_real :280), which
// the whole-run TPU kernels inline.  The TPU version factors N = m*128 so
// its two 128-deep stages ride the 128x128 matrix unit in bf16x3 split dots
// (the JAX default precision HIGH, about float32 accuracy) and keeps the
// spectrum in a permuted (m, 128) order.  None of that carries over: here
// one thread block transforms one frame of N = 2^k points (16 <= N <= 4096)
// held in shared memory as float2, with log2(N) radix-2 butterfly stages in
// FP32 on the CUDA cores (no tensor cores), and the spectrum comes out in
// natural bin order.  FP32 butterflies are at least as accurate as the
// bf16x3 dots of HIGH and match HIGHEST to rounding.
//
// Twiddles tw[k] = exp(-2*pi*i*k/N), k < N/2, are computed in float64 on
// the host, stored as float32 and passed in (as fft4.fourstep_tables does);
// the inverse uses their conjugates.  Scaling (1 or 1/sqrt(N) forward,
// 1/N or 1/sqrt(N) inverse, fft4.py:62-63) is left to the caller, which
// folds it into the pass that reads or writes the spectrum.
//
// What bounds it on an H100: per frame of N = 2048 the transform does
// 11 x 1024 butterflies (about 0.1 MFLOP) against 8 KB of frame I/O, so
// alone it is bound by shared-memory bandwidth and the __syncthreads between
// stages, not by device memory.  The design keeps the whole frame resident
// in shared memory for every stage so that device memory is touched once on
// the way in and once on the way out.
#pragma once

#include <cuda_runtime.h>

namespace specinv {

// Threads per block of a one-frame transform: n/4, clamped to [32, 256].
inline int frame_threads(int n) {
  const int t = n / 4;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ int bit_reverse(int i, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
}

// In-place bit-reversal permutation of each of the `frames` frames of n =
// 2^log2n points held back to back in s.  Ends with a barrier.
__device__ inline void bitrev_permute(float2* s, int n, int log2n, int frames = 1) {
  for (int q = threadIdx.x; q < frames * n; q += blockDim.x) {
    const int i = q & (n - 1);
    const int r = bit_reverse(i, log2n);
    if (i < r) {
      float2* f = s + (q - i);
      const float2 t = f[i];
      f[i] = f[r];
      f[r] = t;
    }
  }
  __syncthreads();
}

// Radix-2 decimation-in-time stages: bit-reversed input in s -> natural-
// order DFT in s (unscaled), for each of `frames` frames of n points held
// back to back (the block's threads share the butterflies of all of them).
// INVERSE uses conj(tw).  Expects a barrier before the call; ends with one.
template <bool INVERSE>
__device__ inline void fft_stages(float2* s, const float2* __restrict__ tw,
                                  int n, int log2n, int frames = 1) {
  const int half = n >> 1;
  for (int st = 0; st < log2n; ++st) {
    const int h = 1 << st;            // butterfly half-span at this stage
    const int stride = half >> st;    // twiddle stride N / (2h)
    for (int q = threadIdx.x; q < frames * half; q += blockDim.x) {
      const int j = q & (half - 1);   // butterfly within its frame
      const int pos = j & (h - 1);
      const int i0 = (q - j) * 2 + ((j >> st) << (st + 1)) + pos;
      const int i1 = i0 + h;
      const float2 w = __ldg(tw + pos * stride);
      const float2 b = INVERSE ? cmul_conj(s[i1], w) : cmul(s[i1], w);
      const float2 a = s[i0];
      s[i0] = make_float2(a.x + b.x, a.y + b.y);
      s[i1] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

// Load a real frame src[0, n) times win[0, n) (no window when win is null)
// into s in bit-reversed order with zero imaginary part, then run the
// forward stages: s holds the natural-order unscaled DFT on return.
__device__ inline void forward_real(float2* s, const float* __restrict__ src,
                                    const float* __restrict__ win,
                                    const float2* __restrict__ tw, int n,
                                    int log2n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = win ? src[i] * win[i] : src[i];
    s[bit_reverse(i, log2n)] = make_float2(v, 0.0f);
  }
  __syncthreads();
  fft_stages<false>(s, tw, n, log2n);
}

// s holds a natural-order spectrum (the full Hermitian spectrum for a
// onesided caller, which writes bin n-k beside bin k).  Permute and run the
// inverse stages: the real part of s is the unscaled inverse DFT on return.
// With `frames` > 1, s holds that many such spectra back to back.
__device__ inline void inverse_inplace(float2* s, const float2* __restrict__ tw,
                                       int n, int log2n, int frames = 1) {
  __syncthreads();
  bitrev_permute(s, n, log2n, frames);
  fft_stages<true>(s, tw, n, log2n, frames);
}

}  // namespace specinv
