// k RTISI-LA output-frame steps per launch for Hopper (sm_90a).
//
// Replaces the TPU kernels specinv_tpu/ops/pallas/rtisi_fused4.py::
// _kernel_multi (:274, k steps per launch, launched at :457 by
// refine_run4_multi) and ::_kernel (:61, one step per launch, launched at
// :197 by refine_run4), which compute the same function at k = 1: the
// offline RTISI_LA and the real-time RTISIStreamer both launch this kernel,
// the streamer with k = 1.
//
// State, in the layout of the port's plain path (RTISIState): committed
// frames keep (B, nk, n), in-flight frames upd (B, R, n) and momentum pre
// (B, R, F) complex64, onesided in natural bin order, with R = la + 1 and
// nk = (n - 1) / hop.  The target is a window of k + la magnitude frames
// (B, k + la, F): step s refines against rows s .. s + la.  Per step:
//
//   xk    = OLA(keep * synth), committed prefix dropped      (once per step)
//   pre   = [pre[1:], 0]         (refinement 0 takes the next frame's momentum)
//   repeat max_iter times (j):
//     xs  = xk + OLA(upd * synth)                      (la*hop + n samples)
//     S_r = FFT(xs[r*hop : r*hop + n] * w_r)   w_r = window, or for the newest
//                                              frame aw_first (j = 0) / aw_rest
//     S   = S - lr * pre;  pre = S
//     upd = Re IFFT(S * tgt / (|S| + 1e-16))
//   commit upd[0] (to com and as the newest committed frame), slide upd
//
// One thread block per stream: the TPU's sequential step grid becomes the
// step loop of the block and the refinements an inner loop, so a launch
// has no host sync and no atomics.  The state lives in the output buffers
// in device memory (a stream's state is a few tens of KB, so it stays in
// L2) and so do the two OLA buffers xk and xs; shared memory holds only the
// FFT scratch of `group` frames at a time (at most 8192 complex points,
// 64 KB), and frames are transformed in groups of that size.  This is one
// code path for every config the wrapper admits (n_fft a power of two in
// [16, 4096], hop <= n_fft, any look-ahead), where the whole state would
// not fit in shared memory (n_fft 4096, or many look-ahead frames).
//
// The arithmetic does not depend on k or on where a step sits in a launch:
// every step runs the same code on state read from device memory, and the
// products and sums outside the FFT are rounded explicitly (__fmul_rn and
// friends are never contracted into an FMA), so k = 1, 3 or 8 and the
// streamer commit the same bits.
//
// What bounds it on an H100: at BASELINE config 3 (n 2048, hop 512, la 3,
// 25 refinements) one launch of k = 8 steps needs 8 x 25 x 4 frames of one
// real forward and one real inverse 2048-point FFT, 2.5 N log2 N flops each
// (90 MFLOP), and the window, momentum, projection and OLA arithmetic beside
// them: about 108 MFLOP per stream, against about 0.3 MB of input and
// output.  Over the whole card (67 TFLOP/s FP32) that is 1.6 us per stream
// and launch, bound by operations; one block per stream runs on one SM
// (about 0.51 TFLOP/s), about 27 us per output frame at batch 1.  This
// kernel transforms each real frame as a complex one, twice the FFT work
// the bound counts.  The radix-2 stages move each frame through shared
// memory 22 times per refinement and wait at a barrier after each, so
// shared-memory traffic and barriers, not FLOPs, bound this design;
// radix-4/8 stages in registers and a half-length real transform are later
// work.
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr float kProjEps = 1e-16f;   // rtisi_la.py PROJ_EPS
constexpr int kGroupPoints = 8192;   // complex points of FFT scratch per block

int group_frames(int n, int R) {
  const int g = kGroupPoints / n;
  return g < R ? g : R;
}

int block_threads(int n, int group) {
  const int t = group * n / 4;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

__global__ void __launch_bounds__(1024) rtisi_steps_kernel(
    float* keep,                         // (B, nk, n), updated in place
    float* upd,                          // (B, R, n), updated in place
    float2* pre,                         // (B, R, F), updated in place
    const float* __restrict__ target,    // (B, k + R - 1, F)
    const float* __restrict__ window,    // (n) analysis window
    const float* __restrict__ aw_first,  // (n) newest frame, refinement 0
    const float* __restrict__ aw_rest,   // (n) newest frame, refinements > 0
    const float* __restrict__ synth,     // (n) window * hop / sum(window^2)
    const float2* __restrict__ tw,       // (n/2) forward twiddles
    float* com,                          // (k, B, n) committed frames
    float* xk,                           // (B, L) scratch
    float* xs,                           // (B, L) scratch
    int B, int k, int R, int nk, int n, int log2n, int hop, int max_iter,
    int group, float lr, float fscale, float iscale) {
  extern __shared__ float2 s[];
  const int b = blockIdx.x;
  const int F = n / 2 + 1;
  const int L = (R - 1) * hop + n;
  float* keep_b = keep + static_cast<size_t>(b) * nk * n;
  float* upd_b = upd + static_cast<size_t>(b) * R * n;
  float2* pre_b = pre + static_cast<size_t>(b) * R * F;
  const float* tgt_b = target + static_cast<size_t>(b) * (k + R - 1) * F;
  float* xk_b = xk + static_cast<size_t>(b) * L;
  float* xs_b = xs + static_cast<size_t>(b) * L;

  for (int step = 0; step < k; ++step) {
    // Committed-context tail: committed frame c starts at (c - nk) * hop.
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      float acc = 0.0f;
      for (int c = 0; c < nk; ++c) {
        const int o = i + (nk - c) * hop;
        if (o < n) acc = __fadd_rn(acc, __fmul_rn(keep_b[c * n + o], synth[o]));
      }
      xk_b[i] = acc;
    }
    // The frame shift of refinement 0's momentum; one thread owns a bin
    // across all frames, so the in-place shift has no hazard.
    for (int q = threadIdx.x; q < F; q += blockDim.x) {
      for (int r = 0; r + 1 < R; ++r) pre_b[r * F + q] = pre_b[(r + 1) * F + q];
      pre_b[(R - 1) * F + q] = make_float2(0.0f, 0.0f);
    }
    __syncthreads();
    const float* tgt_s = tgt_b + static_cast<size_t>(step) * F;

    for (int j = 0; j < max_iter; ++j) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        float acc = xk_b[i];
        const int r_hi = min(R - 1, i / hop);
        for (int r = i >= n ? (i - n) / hop + 1 : 0; r <= r_hi; ++r) {
          const int o = i - r * hop;
          acc = __fadd_rn(acc, __fmul_rn(upd_b[r * n + o], synth[o]));
        }
        xs_b[i] = acc;
      }
      __syncthreads();
      const float* w_new = j == 0 ? aw_first : aw_rest;

      for (int g0 = 0; g0 < R; g0 += group) {
        const int gn = min(group, R - g0);
        for (int q = threadIdx.x; q < gn * n; q += blockDim.x) {
          const int i = q & (n - 1);
          const int r = g0 + (q >> log2n);
          const float w = (r == R - 1 ? w_new : window)[i];
          s[(q - i) + specinv::bit_reverse(i, log2n)] =
              make_float2(__fmul_rn(xs_b[r * hop + i], w), 0.0f);
        }
        __syncthreads();
        specinv::fft_stages<false>(s, tw, n, log2n, gn);

        // Momentum and projection on the stored bins; the Hermitian mirror
        // (bins above n/2, which nobody reads here) feeds the inverse.
        for (int q = threadIdx.x; q < gn * F; q += blockDim.x) {
          const int f = q / F;
          const int kb = q - f * F;
          const int r = g0 + f;
          float2* sf = s + f * n;
          const float2 p = pre_b[r * F + kb];
          float2 v = make_float2(__fmul_rn(sf[kb].x, fscale), __fmul_rn(sf[kb].y, fscale));
          v.x = __fsub_rn(v.x, __fmul_rn(lr, p.x));
          v.y = __fsub_rn(v.y, __fmul_rn(lr, p.y));
          pre_b[r * F + kb] = v;
          const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
          const float g = __fdiv_rn(tgt_s[r * F + kb], __fadd_rn(mag, kProjEps));
          const float2 out = make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
          sf[kb] = out;
          if (kb > 0 && kb < n / 2) sf[n - kb] = make_float2(out.x, -out.y);
        }
        specinv::inverse_inplace(s, tw, n, log2n, gn);
        for (int q = threadIdx.x; q < gn * n; q += blockDim.x) {
          upd_b[g0 * n + q] = __fmul_rn(s[q].x, iscale);
        }
        __syncthreads();
      }
    }

    // Commit the oldest in-flight frame and slide both buffers; one thread
    // owns a sample index across all frames.
    float* com_s = com + (static_cast<size_t>(step) * B + b) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v0 = upd_b[i];
      com_s[i] = v0;
      if (nk > 0) {
        for (int c = 0; c + 1 < nk; ++c) keep_b[c * n + i] = keep_b[(c + 1) * n + i];
        keep_b[(nk - 1) * n + i] = v0;
      }
      for (int r = 0; r + 1 < R; ++r) upd_b[r * n + i] = upd_b[(r + 1) * n + i];
      upd_b[(R - 1) * n + i] = 0.0f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// k RTISI-LA steps for B streams: keep, upd and pre are updated in place,
// com receives the committed frames; xk and xs are (B, (R-1)*hop + n)
// scratch.  Returns the first CUDA error (0 if none).
int specinv_rtisi_steps(float* keep, float* upd, float2* pre,
                        const float* target, const float* window,
                        const float* aw_first, const float* aw_rest,
                        const float* synth, const float2* tw, float* com,
                        float* xk, float* xs, int B, int k, int R, int nk,
                        int n, int log2n, int hop, int max_iter, float lr,
                        float fscale, float iscale, cudaStream_t stream) {
  const int group = group_frames(n, R);
  const size_t smem = static_cast<size_t>(group) * n * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      rtisi_steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rtisi_steps_kernel<<<B, block_threads(n, group), smem, stream>>>(
      keep, upd, pre, target, window, aw_first, aw_rest, synth, tw, com, xk,
      xs, B, k, R, nk, n, log2n, hop, max_iter, group, lr, fscale, iscale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
