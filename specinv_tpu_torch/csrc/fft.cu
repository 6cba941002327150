// Batched entry points for the device FFT of fft.cuh, one frame per block.
//
// These exist so the transform can be held against its plain PyTorch
// version (specinv_tpu_torch/ops/cuda/fft.py::fft_reference) on its own;
// the whole-run kernels (fullrun.cuh) inline the same device functions.
// Replaces specinv_tpu/ops/pallas/fft4.py fwd4_lane (:322) and
// inv4_real_lane (:367); see fft.cuh for the design and what bounds it.
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

__global__ void fft_r2c_kernel(const float* __restrict__ x,
                               float2* __restrict__ out,
                               const float2* __restrict__ tw, int n, int log2n,
                               int n_bins, float scale) {
  extern __shared__ float2 s[];
  const size_t row = blockIdx.x;
  specinv::forward_real(s, x + row * n, nullptr, tw, n, log2n);
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    out[row * n_bins + k] = make_float2(s[k].x * scale, s[k].y * scale);
  }
}

__global__ void fft_c2r_kernel(const float2* __restrict__ spec,
                               float* __restrict__ out,
                               const float2* __restrict__ tw, int n, int log2n,
                               int n_bins, int onesided, float scale) {
  extern __shared__ float2 s[];
  const size_t row = blockIdx.x;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const float2 v = spec[row * n_bins + k];
    s[k] = v;
    if (onesided && k > 0 && k < n / 2) s[n - k] = make_float2(v.x, -v.y);
  }
  specinv::inverse_inplace(s, tw, n, log2n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row * n + i] = s[i].x * scale;
  }
}

}  // namespace

extern "C" {

// x (rows, n) real -> out (rows, n_bins) complex, n_bins = n/2+1 or n.
int specinv_fft_r2c(const float* x, float2* out, const float2* tw, int rows,
                    int n, int log2n, int n_bins, float scale,
                    cudaStream_t stream) {
  fft_r2c_kernel<<<rows, specinv::frame_threads(n), n * sizeof(float2), stream>>>(
      x, out, tw, n, log2n, n_bins, scale);
  return static_cast<int>(cudaGetLastError());
}

// spec (rows, n_bins) complex -> out (rows, n) real part of the inverse DFT;
// onesided spectra are extended by Hermitian symmetry.
int specinv_fft_c2r(const float2* spec, float* out, const float2* tw, int rows,
                    int n, int log2n, int n_bins, int onesided, float scale,
                    cudaStream_t stream) {
  fft_c2r_kernel<<<rows, specinv::frame_threads(n), n * sizeof(float2), stream>>>(
      spec, out, tw, n, log2n, n_bins, onesided, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* specinv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
