// Whole-run Griffin-Lim for Hopper (sm_90a): one iteration is two launches,
// and the wrapper (ops/cuda/gl_fullrun.py) queues n_iters of them on one
// stream with no host sync.
//
// Replaces the TPU kernel specinv_tpu/ops/pallas/fullrun_lane.py::_kernel
// (:377, algo='gl', launched at :911 by fused_run_lane, driven as
// gl_fullrun4.fused_gl_run), which runs every iteration inside one launch
// with the signal and momentum planes resident in the TPU's VMEM.  What it
// computes per iteration, for every clip b and frame t:
//
//   S      = FFT(window * x_pad[b, t*hop : t*hop + n_fft])   (onesided bins)
//   mag    = |S|                       (eval iteration only: plane or sums)
//   S      = S - lr * pre[b, t];  pre[b, t] = S              (momentum)
//   P      = S * target[b, t] / (|S| + 1e-16)                (projection)
//   frame  = window * Re(IFFT(Hermitian-extended P))
//   y      = OLA(frames) * inv_env;  x_pad = repad_edges(y)
//
// The TPU layout choices (128-lane alignment, permuted spectra, hop-row
// slabs, clip packing, bf16x3 dots) do not carry over.  Here:
//
// * gl_frame_kernel: one block per (frame, clip).  It loads the windowed
//   frame, runs the forward FFT in shared memory (fft.cuh), emits the eval
//   output on the last iteration of an eval segment (the magnitude plane, or
//   per-frame partial sums of (|S|-tgt)^2 and |S|^2 over the onesided bins),
//   applies momentum and projection, stores the new state, writes the
//   Hermitian mirror in place, runs the inverse FFT and writes the windowed
//   frame to a (B, T, n_fft) scratch.  The state is stored onesided in
//   natural bin order as complex64; it stays Hermitian, so this is exact.
// * gl_ola_kernel: one thread per output sample.  It gathers its at most
//   ceil(n_fft/hop) frame terms in ascending frame order (no atomics, so the
//   result is deterministic), multiplies by inv_env and writes the other
//   buffer of a double-buffered x_pad.  A sample in an edge pad computes the
//   OLA value at the source index repad_edges would copy from (reflect,
//   replicate, circular; constant pads are zero), so no block reads another
//   block's output within a launch.
//
// What bounds it on an H100: at the main path (n_fft 2048, hop 512, 431
// frames) each onesided complex64 state plane is 431 x 1025 x 8 B, about
// 3.5 MB, the float32 target 1.8 MB and the frame scratch 3.5 MB, so an
// iteration moves about 16 MB through device memory (all of it fits in the
// 50 MB L2), while the two FFTs do about 2 x 11 x 1024 butterflies per frame
// in shared memory.  With 431 blocks of 256 threads on 132 SMs the frame
// kernel is bound by the shared-memory butterfly stages and their barriers,
// and the OLA kernel by memory traffic.  The design touches device memory
// once per plane per iteration and keeps the frame in shared memory across
// both transforms; fusing the two launches into a persistent kernel with a
// grid barrier, CUDA graphs and tensor-core DFT stages are later work.
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr float kProjEps = 1e-16f;  // griffin_lim.py:38 PROJ_EPS

enum PadMode { kConstant = 0, kReflect = 1, kReplicate = 2, kCircular = 3 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void gl_frame_kernel(
    const float* __restrict__ x_pad,     // (B, lp)
    float2* __restrict__ pre,            // (B, T, F) state, updated in place
    const float* __restrict__ target,    // (B, T, F)
    const float* __restrict__ window,    // (n)
    const float2* __restrict__ tw,       // (n/2) forward twiddles
    float* __restrict__ frames,          // (B, T, n) windowed output frames
    float* __restrict__ mag,             // (B, T, F) or null
    float* __restrict__ stats,           // (B, T, 2) or null
    int T, int n, int log2n, int hop, int n_bins, int lp, int onesided,
    float lr, float fscale, float iscale, int valid_t) {
  extern __shared__ float2 s[];
  __shared__ float red[2][32];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * T + t;

  specinv::forward_real(s, x_pad + static_cast<size_t>(b) * lp +
                               static_cast<size_t>(t) * hop,
                        window, tw, n, log2n);

  float l0 = 0.0f, l1 = 0.0f;
  const bool in_sums = stats != nullptr && t < valid_t;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const size_t idx = row * n_bins + k;
    float2 v = make_float2(s[k].x * fscale, s[k].y * fscale);
    if (mag != nullptr || in_sums) {
      const float m = sqrtf(v.x * v.x + v.y * v.y);
      if (mag != nullptr) mag[idx] = m;
      if (in_sums) {
        const float d = m - target[idx];
        l0 += d * d;
        l1 += m * m;
      }
    }
    const float2 p = pre[idx];
    v.x -= lr * p.x;
    v.y -= lr * p.y;
    pre[idx] = v;
    const float g = target[idx] / (sqrtf(v.x * v.x + v.y * v.y) + kProjEps);
    v.x *= g;
    v.y *= g;
    // This thread alone reads bin k in this loop; bin n-k (onesided, 0 < k
    // < n/2) lies above n_bins and is read by nobody here.
    s[k] = v;
    if (onesided && k > 0 && k < n / 2) s[n - k] = make_float2(v.x, -v.y);
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

  specinv::inverse_inplace(s, tw, n, log2n);
  float* out = frames + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[i] = s[i].x * iscale * window[i];
  }
}

__global__ void gl_ola_kernel(const float* __restrict__ frames,   // (B, T, n)
                              const float* __restrict__ inv_env,  // (lp)
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
  x_out[idx] = acc * inv_env[src];
}

int frame_threads(int n) {
  int t = n / 4;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

}  // namespace

extern "C" {

// One Griffin-Lim iteration: x_in -> x_out (distinct buffers), pre updated
// in place.  mag and stats may be null; stats gets per-frame partial sums.
int specinv_gl_iteration(const float* x_in, float* x_out, float2* pre,
                         const float* target, const float* window,
                         const float2* tw, const float* inv_env, float* frames,
                         float* mag, float* stats, int B, int T, int n,
                         int log2n, int hop, int n_bins, int lp, int onesided,
                         int p_amt, int e, int pad_mode, float lr, float fscale,
                         float iscale, int valid_t, cudaStream_t stream) {
  const dim3 grid(T, B);
  gl_frame_kernel<<<grid, frame_threads(n), n * sizeof(float2), stream>>>(
      x_in, pre, target, window, tw, frames, mag, stats, T, n, log2n, hop,
      n_bins, lp, onesided, lr, fscale, iscale, valid_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const size_t total = static_cast<size_t>(B) * lp;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  gl_ola_kernel<<<blocks, threads, 0, stream>>>(frames, inv_env, x_out, B, T, n,
                                                hop, lp, p_amt, e, pad_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
