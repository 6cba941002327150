// Whole-run ADMM phase retrieval for Hopper (sm_90a): one iteration is two
// launches, and the wrapper (ops/cuda/admm_fullrun.py) queues n_iters of
// them on one stream with no host sync.
//
// Replaces two TPU kernels that compute the same function:
// specinv_tpu/ops/pallas/fullrun_lane.py::_kernel (:377, algo='admm',
// launched at :911 by fused_run_lane) and admm_fused4.py::_kernel_full
// (:275, the (m, 128) layout, launched at :516), both driven as
// admm_fused4.fused_admm_run.  They run every iteration inside one launch
// with the signal and the state resident in the TPU's VMEM.  One call with
// a null inv_env (and p_amt = 0) is the raw per-iteration dispatch,
// ops/cuda/admm_fullrun.py::fused_admm_iteration: it
// replaces admm_fused4.py::_kernel_iter (:89, launched at :227), which the
// sequence-parallel path runs once per iteration and shard with that
// shard's true-frame count as valid_t (0 on a shard of padding rows).
//
// The state is the Douglas-Rachford one-variable reduction of the
// reference's (X, Y, U) chain (admm_fused4.py:10-28): since Y = X + U, the
// dual update U' = U + X - Z equals Y - Z, and only Y persists.  Per
// iteration, for every clip b and frame t:
//
//   R   = FFT(window * x_pad[b, t*hop : t*hop + n_fft])   (onesided bins)
//   mag = |R|                          (eval iteration only: plane or sums)
//   Z   = (rho*Y + R) / (1 + rho)      (true division, as the JAX code does)
//   U'  = Y - Z ;  T' = Z - U'
//   Y'  = T' * target / (|T'| + 1e-16) + U' ;  Y' = 0 for frames t >= valid_t
//   frame = window * Re(IFFT(Hermitian-extended Y'))
//   y   = OLA(frames) * inv_env ;  x_pad = repad_edges(y)
//
// The inverse transforms Y', not the projection.  The frame and OLA launches
// are the shared engine of fullrun.cuh; this file supplies the ADMM middle.
//
// What bounds it on an H100: the state is one onesided complex64 Y plane,
// the footprint of Griffin-Lim's momentum plane (the TPU's DR reduction
// exists to get it).  At config 2 (n_fft 2048, hop 512, 431 frames) the Y
// plane is 431 x 1025 x 8 B, about 3.5 MB, and an iteration moves about
// 16 MB through device memory, all inside the 50 MB L2; the middle adds a
// few FLOPs per bin.  431 frames fill less than one wave of the 132 SMs, so
// the frame launch costs about one frame's latency, which the radix-2
// complex transform it replaced stretched over about 25 barriers per frame.
// The design is Griffin-Lim's (gl_fullrun.cu): the FP64 half-length real
// FFT of rfft.cuh in radix-8 register stages and the DR update inside its
// one pair pass; device memory is touched once per plane per iteration.
#include <cuda_runtime.h>

#include "fullrun.cuh"

namespace {

// The DR-reduced update; Y' = 0 on frames past valid_t.
struct ADMMMiddle {
  float rho;
  __device__ __forceinline__ float2 operator()(float2 r, float2& y, float tgt,
                                               bool valid) const {
    const float onep = 1.0f + rho;
    const float2 z = make_float2((rho * y.x + r.x) / onep, (rho * y.y + r.y) / onep);
    const float2 u = make_float2(y.x - z.x, y.y - z.y);
    const float2 t = make_float2(z.x - u.x, z.y - u.y);
    const float g = tgt / (sqrtf(t.x * t.x + t.y * t.y) + specinv::kProjEps);
    y = valid ? make_float2(t.x * g + u.x, t.y * g + u.y) : make_float2(0.0f, 0.0f);
    return y;
  }
};

}  // namespace

extern "C" {

// One ADMM iteration: x_in -> x_out (distinct buffers), Y updated in place.
// mag and stats may be null; stats gets per-frame partial sums of the
// pre-update |R| over the first valid_t frames.  A null inv_env leaves the
// raw OLA.  The frame launch runs on the plan (fpb, threads, smem) of
// _fullrun.frame_plan.
int specinv_admm_iteration(const float* x_in, float* x_out, float2* y,
                           const float* target, const float* window,
                           const double2* tw, const float* inv_env,
                           float* frames, float* mag, float* stats, int B,
                           int T, int n, int log2n, int hop, int n_bins,
                           int lp, int onesided, int p_amt, int e,
                           int pad_mode, float rho, float fscale, float iscale,
                           int valid_t, int fpb, int threads, int smem,
                           cudaStream_t stream) {
  return specinv::run_iteration(
      x_in, x_out, y, target, window, tw, inv_env, frames, mag, stats, B, T, n,
      log2n, hop, n_bins, lp, onesided, p_amt, e, pad_mode, fscale, iscale,
      valid_t, fpb, threads, smem, ADMMMiddle{rho}, stream);
}

}  // extern "C"
