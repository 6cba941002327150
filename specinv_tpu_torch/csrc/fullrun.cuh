// The iteration engine shared by the whole-run kernels (gl_fullrun.cu,
// admm_fullrun.cu): one iteration is a frame launch and an OLA launch.
//
// * frame_kernel<Middle>: one block per (frame, clip).  It loads the
//   windowed frame, runs the forward FFT in shared memory (fft.cuh), emits
//   the eval output on the last iteration of an eval segment (the magnitude
//   plane, or per-frame partial sums of (|S|-tgt)^2 and |S|^2 over the
//   stored bins of the first valid_t frames), hands each stored bin to the
//   algorithm's Middle (which updates the state plane in place and returns
//   the spectrum to invert), writes the Hermitian mirror in place, runs the
//   inverse FFT and writes the windowed frame to a (B, T, n_fft) scratch.
//   The state is stored onesided in natural bin order as complex64; it stays
//   Hermitian, so this is exact.
// * ola_kernel: one thread per output sample.  It gathers its at most
//   ceil(n_fft/hop) frame terms in ascending frame order (no atomics, so the
//   result is deterministic), multiplies by inv_env and writes the other
//   buffer of a double-buffered x_pad.  A sample in an edge pad computes the
//   OLA value at the source index repad_edges would copy from (reflect,
//   replicate, circular; constant pads are zero), so no block reads another
//   block's output within a launch.  A null inv_env with p_amt = 0 leaves
//   the raw overlap-add, which the sequence-parallel path divides by the
//   envelope only after the halo exchange.
//
// A Middle is a functor with
//   __device__ float2 operator()(float2 s, float2& state, float tgt,
//                                bool valid) const;
// where s is the scaled forward bin, state the bin's state (read, then
// overwritten), tgt the target magnitude and valid whether the frame lies
// below valid_t.
#pragma once

#include <cuda_runtime.h>

#include "fft.cuh"

namespace specinv {
namespace {

constexpr float kProjEps = 1e-16f;  // griffin_lim.py:38 PROJ_EPS

enum PadMode { kConstant = 0, kReflect = 1, kReplicate = 2, kCircular = 3 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <class Middle>
__global__ void frame_kernel(
    const float* __restrict__ x_pad,     // (B, lp)
    float2* __restrict__ state,          // (B, T, F) state, updated in place
    const float* __restrict__ target,    // (B, T, F)
    const float* __restrict__ window,    // (n)
    const float2* __restrict__ tw,       // (n/2) forward twiddles
    float* __restrict__ frames,          // (B, T, n) windowed output frames
    float* __restrict__ mag,             // (B, T, F) or null
    float* __restrict__ stats,           // (B, T, 2) or null
    int T, int n, int log2n, int hop, int n_bins, int lp, int onesided,
    float fscale, float iscale, int valid_t, Middle middle) {
  extern __shared__ float2 s[];
  __shared__ float red[2][32];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * T + t;

  forward_real(s, x_pad + static_cast<size_t>(b) * lp +
                      static_cast<size_t>(t) * hop,
               window, tw, n, log2n);

  float l0 = 0.0f, l1 = 0.0f;
  const bool valid = t < valid_t;
  const bool in_sums = stats != nullptr && valid;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const size_t idx = row * n_bins + k;
    // Rounded products (__fmul_rn is never fused into an FMA): where the
    // eval branch below is skipped, the compiler could otherwise fold the
    // scaling into the middle's first FMA, and an eval iteration would then
    // round differently from the others.
    const float2 v = make_float2(__fmul_rn(s[k].x, fscale), __fmul_rn(s[k].y, fscale));
    if (mag != nullptr || in_sums) {
      const float m = sqrtf(v.x * v.x + v.y * v.y);
      if (mag != nullptr) mag[idx] = m;
      if (in_sums) {
        const float d = m - target[idx];
        l0 += d * d;
        l1 += m * m;
      }
    }
    float2 st = state[idx];
    const float2 p = middle(v, st, target[idx], valid);
    state[idx] = st;
    // This thread alone reads bin k in this loop; bin n-k (onesided, 0 < k
    // < n/2) lies above n_bins and is read by nobody here.
    s[k] = p;
    if (onesided && k > 0 && k < n / 2) s[n - k] = make_float2(p.x, -p.y);
  }

  if (stats != nullptr) {
    l0 = warp_sum(l0);
    l1 = warp_sum(l1);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      red[0][warp] = l0;
      red[1][warp] = l1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = 0.0f, c = 0.0f;
      for (int w = 0; w < (blockDim.x + 31) / 32; ++w) {
        a += red[0][w];
        c += red[1][w];
      }
      stats[row * 2] = a;
      stats[row * 2 + 1] = c;
    }
  }

  inverse_inplace(s, tw, n, log2n);
  float* out = frames + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[i] = s[i].x * iscale * window[i];
  }
}

__global__ void ola_kernel(const float* __restrict__ frames,   // (B, T, n)
                           const float* __restrict__ inv_env,  // (lp) or null
                           float* __restrict__ x_out,          // (B, lp)
                           int B, int T, int n, int hop, int lp, int p_amt,
                           int e, int pad_mode) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * lp) return;
  const int b = static_cast<int>(idx / lp);
  const int i = static_cast<int>(idx % lp);

  // repad_edges (models/_kernel_driver.py): the source of an edge sample
  int src = i;
  if (p_amt > 0 && (i < p_amt || i > e)) {
    if (pad_mode == kConstant) {
      x_out[idx] = 0.0f;
      return;
    }
    const bool left = i < p_amt;
    const int j = left ? i : i - (e + 1);
    if (pad_mode == kReflect) {
      src = left ? 2 * p_amt - j : e - 1 - j;
    } else if (pad_mode == kReplicate) {
      src = left ? p_amt : e;
    } else {  // kCircular
      src = left ? e - p_amt + 1 + j : p_amt + j;
    }
  }

  const int t_hi = min(T - 1, src / hop);
  const int t_lo = src >= n ? (src - n) / hop + 1 : 0;
  const float* fb = frames + static_cast<size_t>(b) * T * n;
  float acc = 0.0f;
  for (int t = t_lo; t <= t_hi; ++t) {
    acc += fb[static_cast<size_t>(t) * n + (src - t * hop)];
  }
  x_out[idx] = inv_env != nullptr ? acc * inv_env[src] : acc;
}

// One iteration: x_in -> x_out (distinct buffers), state updated in place.
// mag and stats may be null.  Returns the first launch error (0 if none).
template <class Middle>
int run_iteration(const float* x_in, float* x_out, float2* state,
                  const float* target, const float* window, const float2* tw,
                  const float* inv_env, float* frames, float* mag,
                  float* stats, int B, int T, int n, int log2n, int hop,
                  int n_bins, int lp, int onesided, int p_amt, int e,
                  int pad_mode, float fscale, float iscale, int valid_t,
                  Middle middle, cudaStream_t stream) {
  const dim3 grid(T, B);
  frame_kernel<Middle><<<grid, frame_threads(n), n * sizeof(float2), stream>>>(
      x_in, state, target, window, tw, frames, mag, stats, T, n, log2n, hop,
      n_bins, lp, onesided, fscale, iscale, valid_t, middle);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const size_t total = static_cast<size_t>(B) * lp;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  ola_kernel<<<blocks, threads, 0, stream>>>(frames, inv_env, x_out, B, T, n,
                                             hop, lp, p_amt, e, pad_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace specinv
