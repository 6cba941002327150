// One DR-ADMM iteration through the direct DFT, for Hopper (sm_90a): the
// frame split, the forward product with the ADMM middle, the inverse
// product and the overlap-add (dft_iter.cuh), four launches, the products
// on the tensor cores or, in 'highest', as float32 FFMA.  The wrapper
// (ops/cuda/admm_fused.py) launches one iteration per call.
//
// Replaces the TPU kernel specinv_tpu/ops/pallas/admm_fused.py::_kernel
// (:41, launched at :208 by fused_admm_iteration), the iteration of
// ADMM(backend='pallas').  It is gl_fused.cu with another middle: the
// Douglas-Rachford one-variable reduction of the reference's (X, Y, U)
// chain, in which only Y persists (admm_fused.py:9-17).  Per iteration, for
// every clip b and frame t:
//
//   R   = frames @ C  -  i * frames @ Sn            (the scheme's passes)
//   mag = |R|                                       (pre-update)
//   Z   = (rho*Y + R) / (1 + rho)                   (true division)
//   U'  = Y - Z ;  T' = Z - U'
//   Y'  = T' * tgt / (|T'| + 1e-16) + U' ;  Y' = 0 for frames t >= valid_t
//   frame = window * ((Y' w)_re @ C^T - (Y' w)_im @ Sn^T)
//   x_pad = repad_edges(OLA(frames) * inv_env)
//
// The inverse operand is Y' times the fold weights (admm_fused.py:130-134).
// The port keeps no padded frame rows, so valid_t < T only when a caller
// asks for it; the mask is applied all the same.
//
// What bounds it on an H100: the products are gl_fused.cu's (config 2 has
// config 1's shapes: HIGH 21.7 GFLOP, 21.9 us of dense bf16; HIGHEST 108 us
// of float32) and the middle adds about 20 FLOP per bin; every tier is
// bound by its operations, and the engine's wgmma products are held above
// that by L2 (gl_fused.cu).
#include <cuda_runtime.h>

#include "dft_iter.cuh"

namespace {

// The DR-reduced update; Y' = 0 on frames past valid_t.  Returns Y' * w.
struct ADMMDftMiddle {
  float rho;
  __device__ __forceinline__ float2 operator()(float2 r, float2& y, float tgt,
                                               float w, bool valid) const {
    const float onep = __fadd_rn(1.0f, rho);
    const float2 z = make_float2(__fdiv_rn(__fadd_rn(__fmul_rn(rho, y.x), r.x), onep),
                                 __fdiv_rn(__fadd_rn(__fmul_rn(rho, y.y), r.y), onep));
    const float2 u = make_float2(__fsub_rn(y.x, z.x), __fsub_rn(y.y, z.y));
    const float2 t = make_float2(__fsub_rn(z.x, u.x), __fsub_rn(z.y, u.y));
    const float norm = __fadd_rn(
        __fsqrt_rn(__fadd_rn(__fmul_rn(t.x, t.x), __fmul_rn(t.y, t.y))), specinv::kProjEps);
    const float g = __fdiv_rn(tgt, norm);
    y = valid ? make_float2(__fadd_rn(__fmul_rn(t.x, g), u.x),
                            __fadd_rn(__fmul_rn(t.y, g), u.y))
              : make_float2(0.0f, 0.0f);
    return make_float2(__fmul_rn(y.x, w), __fmul_rn(y.y, w));
  }
};

}  // namespace

extern "C" {

// One iteration: x_in -> x_out (distinct buffers), y_in -> y_out (may
// be one buffer), mag may be null.  The tables (ops/cuda/_dft.py): fwd
// (2 F_pad, n_pad) and inv (n_pad, 2 F_pad), in float32 for 'highest' and
// as bf16 halves for the split schemes; the scratch: the frames (B, T, n),
// the forward's frames (B, T, n_pad), float32 for a 'highest' forward or
// split into bf16 halves, and P for the inverse (B, T, 2 F_pad), float32
// for a 'highest' inverse or split; a buffer may be null where the schemes
// read none.  fwd_scheme and inv_scheme are dft_iter.cuh Scheme codes.
int specinv_admm_dft_iteration(
    const float* x_in, float* x_out, const float2* y_in, float2* y_out,
    const float* target, const float* window, const float* wts, const float* fwd_f32,
    const float* inv_f32, const __nv_bfloat16* fwd_hi, const __nv_bfloat16* fwd_lo,
    const __nv_bfloat16* inv_hi, const __nv_bfloat16* inv_lo, const float* inv_env,
    float* frames, float* mag, float* frame_f32, __nv_bfloat16* frame_hi,
    __nv_bfloat16* frame_lo, float* p_f32, __nv_bfloat16* p_hi, __nv_bfloat16* p_lo, int B,
    int T, int n, int hop, int n_bins, int lp, int p_amt, int e, int pad_mode, int fwd_scheme,
    int inv_scheme, float rho, int valid_t, cudaStream_t stream) {
  const specinv::Buffers buf{fwd_f32, inv_f32, fwd_hi, fwd_lo, inv_hi, inv_lo, frame_f32,
                             frame_hi, frame_lo, {p_f32, p_hi, p_lo}, frames};
  return specinv::run_dft_iteration(x_in, x_out, y_in, y_out, target, window, wts, buf,
                                    inv_env, mag, B, T, n, hop, n_bins, lp, p_amt, e, pad_mode,
                                    fwd_scheme, inv_scheme, valid_t, ADMMDftMiddle{rho}, stream);
}

}  // extern "C"
