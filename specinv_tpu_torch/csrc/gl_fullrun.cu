// Whole-run Griffin-Lim for Hopper (sm_90a): one iteration is two launches,
// and the wrapper (ops/cuda/gl_fullrun.py) queues n_iters of them on one
// stream with no host sync.
//
// Replaces the TPU kernels specinv_tpu/ops/pallas/fullrun_lane.py::_kernel
// (:377, algo='gl', launched at :911 by fused_run_lane, driven as
// gl_fullrun4.fused_gl_run) and gl_fullrun4.py::_kernel (:223, the same
// function in the (m, 128) layout, which fused_gl_run takes when hop does
// not divide n_fft or lane=False).  Both run every iteration inside one
// launch with the signal and momentum planes resident in the TPU's VMEM.
// One call with a null inv_env (and p_amt = 0) is the raw per-iteration
// dispatch, ops/cuda/gl_fullrun.py::fused_gl_iteration: it
// replaces specinv_tpu/ops/pallas/gl_fused4.py::_kernel (:110, launched at
// :265), which the sequence-parallel path runs once per iteration and shard
// and which stops at the raw overlap-add.
// What it computes per iteration, for every clip b and frame t:
//
//   S      = FFT(window * x_pad[b, t*hop : t*hop + n_fft])   (onesided bins)
//   mag    = |S|                       (eval iteration only: plane or sums)
//   S      = S - lr * pre[b, t];  pre[b, t] = S              (momentum)
//   P      = S * target[b, t] / (|S| + 1e-16)                (projection)
//   frame  = window * Re(IFFT(Hermitian-extended P))
//   y      = OLA(frames) * inv_env;  x_pad = repad_edges(y)
//
// The TPU layout choices (128-lane alignment, permuted spectra, hop-row
// slabs, clip packing, bf16x3 dots) do not carry over.  The frame and OLA
// launches are the shared engine of fullrun.cuh; this file supplies the
// Griffin-Lim middle (momentum and projection).
//
// What bounds it on an H100: at the main path (n_fft 2048, hop 512, 431
// frames) each onesided complex64 state plane is 431 x 1025 x 8 B, about
// 3.5 MB, the float32 target 1.8 MB and the frame scratch 3.5 MB, so an
// iteration moves about 16 MB through device memory (all of it fits in the
// 50 MB L2, about 5 us at 3.35 TB/s) and its two transforms do about 0.9
// MFLOP per frame; 431 frames fill less than one wave of the 132 SMs, so
// the frame launch costs about one frame's latency.  The radix-2 complex
// transform it replaced waited at about 25 barriers per frame, with a
// twiddle load from device memory in every butterfly.  The engine now runs
// the half-length real FFT of rfft.cuh in FP64 (radix-8 stages in registers,
// the twiddle table in shared memory, 8 barriers per frame at n_fft 2048),
// and the momentum and projection inside its one pair pass, whose state and
// target loads go out together.  Fusing the two launches into a persistent
// kernel with a grid barrier and CUDA graphs are later work.
#include <cuda_runtime.h>

#include "fullrun.cuh"

namespace {

// Momentum S - lr*pre (stored as the new pre), then the projection.
struct GLMiddle {
  float lr;
  __device__ __forceinline__ float2 operator()(float2 v, float2& pre,
                                               float tgt, bool) const {
    v.x -= lr * pre.x;
    v.y -= lr * pre.y;
    pre = v;
    const float g = tgt / (sqrtf(v.x * v.x + v.y * v.y) + specinv::kProjEps);
    v.x *= g;
    v.y *= g;
    return v;
  }
};

}  // namespace

extern "C" {

// One Griffin-Lim iteration: x_in -> x_out (distinct buffers), pre updated
// in place.  mag and stats may be null; stats gets per-frame partial sums
// over the first valid_t frames.  A null inv_env leaves the raw OLA.  The
// frame launch runs on the plan (fpb, threads, smem) of _fullrun.frame_plan.
int specinv_gl_iteration(const float* x_in, float* x_out, float2* pre,
                         const float* target, const float* window,
                         const double2* tw, const float* inv_env, float* frames,
                         float* mag, float* stats, int B, int T, int n,
                         int log2n, int hop, int n_bins, int lp, int onesided,
                         int p_amt, int e, int pad_mode, float lr, float fscale,
                         float iscale, int valid_t, int fpb, int threads, int smem,
                         cudaStream_t stream) {
  return specinv::run_iteration(
      x_in, x_out, pre, target, window, tw, inv_env, frames, mag, stats, B, T,
      n, log2n, hop, n_bins, lp, onesided, p_amt, e, pad_mode, fscale, iscale,
      valid_t, fpb, threads, smem, GLMiddle{lr}, stream);
}

}  // extern "C"
