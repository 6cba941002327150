// One Griffin-Lim iteration through the direct DFT, for Hopper (sm_90a):
// the frame split, the forward product with the Griffin-Lim middle, the
// inverse product and the overlap-add (dft_iter.cuh), four launches.  The
// products run on the tensor cores in the bf16 schemes and as float32 FFMA
// on the CUDA cores in 'highest', both from the same TMA ring.  The wrapper
// (ops/cuda/gl_fused.py) launches one iteration per call.
//
// Replaces the TPU kernel specinv_tpu/ops/pallas/gl_fused.py::_kernel
// (:193, launched at :383 by fused_gl_iteration), the iteration of
// griffin_lim(backend='pallas').  Per iteration, for every clip b and frame t:
//
//   frames = window * x_pad[b, t*hop : t*hop + n_fft]
//   S      = frames @ C  -  i * frames @ Sn        (the scheme's passes)
//   mag    = |S|                                   (pre-momentum)
//   S      = S - lr * pre;  pre = S
//   P      = S * (tgt / (|S| + 1e-16) * w)         (w folded into the gain,
//                                                   gl_fused.py:284)
//   frame  = window * (P_re @ C^T - P_im @ Sn^T)
//   x_pad  = repad_edges(OLA(frames) * inv_env)
//
// The TPU kernel keeps the frames and both spectra in VMEM and sweeps the
// bins as the innermost, sequential grid axis, carrying the inverse partial
// sums across grid steps.  CUDA blocks cannot carry anything, so the port
// writes the split frames, P and the windowed frames to device memory
// between the launches; at the main path they fit in the 50 MB L2.
//
// What bounds it on an H100: at config 1 (431 frames, n_fft 2048, F 1025)
// one split pass of both products is 2 x 2 x 2 x 431 x 2048 x 1025 = 7.24
// GFLOP, so HIGH (three passes) is 21.7 GFLOP, 21.9 us at the 989 TFLOP/s
// of dense bf16, and HIGHEST 7.24 GFLOP of float32, 108 us at 67 TFLOP/s;
// the bytes (state, target, mag, P, frames, tables) are about 40 MB, 12 us
// at 3.35 TB/s.  Every tier is bound by its operations.  The engine feeds
// wgmma, or for HIGHEST register-tiled FFMA, from a TMA ring (dft_iter.cuh);
// what holds the split tiers above the bound is L2: at 431 frames a 64 x
// 128 tile per SM streams its table and data slabs once per product, about
// 180 MB of L2 reads per product at HIGH.  HIGHEST's 64 x 128 tiles give
// 119 and 112 CTAs for 132 SMs at B = 1, so at most 90 % and 85 % of the
// FP32 rate.
#include <cuda_runtime.h>

#include "dft_iter.cuh"

namespace {

// Momentum S - lr*pre (stored as the new pre), then the projection with
// the fold weight in the gain; every product and sum rounded on its own.
struct GLDftMiddle {
  float lr;
  __device__ __forceinline__ float2 operator()(float2 s, float2& pre, float tgt,
                                               float w, bool) const {
    s.x = __fsub_rn(s.x, __fmul_rn(lr, pre.x));
    s.y = __fsub_rn(s.y, __fmul_rn(lr, pre.y));
    pre = s;
    const float norm = __fadd_rn(
        __fsqrt_rn(__fadd_rn(__fmul_rn(s.x, s.x), __fmul_rn(s.y, s.y))), specinv::kProjEps);
    const float g = __fmul_rn(__fdiv_rn(tgt, norm), w);
    return make_float2(__fmul_rn(s.x, g), __fmul_rn(s.y, g));
  }
};

}  // namespace

extern "C" {

// One iteration: x_in -> x_out (distinct buffers), pre_in -> pre_out (may
// be one buffer), mag may be null.  The tables (ops/cuda/_dft.py): fwd
// (2 F_pad, n_pad) and inv (n_pad, 2 F_pad), in float32 for 'highest' and
// as bf16 halves for the split schemes; the scratch: the frames (B, T, n),
// the forward's frames (B, T, n_pad), float32 for a 'highest' forward or
// split into bf16 halves, and P for the inverse (B, T, 2 F_pad), float32
// for a 'highest' inverse or split; a buffer may be null where the schemes
// read none.  fwd_scheme and inv_scheme are dft_iter.cuh Scheme codes.
int specinv_gl_dft_iteration(
    const float* x_in, float* x_out, const float2* pre_in, float2* pre_out,
    const float* target, const float* window, const float* wts, const float* fwd_f32,
    const float* inv_f32, const __nv_bfloat16* fwd_hi, const __nv_bfloat16* fwd_lo,
    const __nv_bfloat16* inv_hi, const __nv_bfloat16* inv_lo, const float* inv_env,
    float* frames, float* mag, float* frame_f32, __nv_bfloat16* frame_hi,
    __nv_bfloat16* frame_lo, float* p_f32, __nv_bfloat16* p_hi, __nv_bfloat16* p_lo, int B,
    int T, int n, int hop, int n_bins, int lp, int p_amt, int e, int pad_mode, int fwd_scheme,
    int inv_scheme, float lr, cudaStream_t stream) {
  const specinv::Buffers buf{fwd_f32, inv_f32, fwd_hi, fwd_lo, inv_hi, inv_lo, frame_f32,
                             frame_hi, frame_lo, {p_f32, p_hi, p_lo}, frames};
  return specinv::run_dft_iteration(x_in, x_out, pre_in, pre_out, target, window, wts, buf,
                                    inv_env, mag, B, T, n, hop, n_bins, lp, p_amt, e, pad_mode,
                                    fwd_scheme, inv_scheme, T, GLDftMiddle{lr}, stream);
}

}  // extern "C"
