// Kernel B: batched stand-alone entry points of the half-length real FFT
// of rfft.cuh in FP64, the transform the whole-run kernels A and C inline
// (fullrun.cuh), launched as they launch it: n/16 threads per frame, one
// frame per block (a whole warp's worth below n = 512), the twiddle table
// in shared memory.
//
// These exist so the transform can be held against its plain PyTorch
// version (specinv_tpu_torch/ops/cuda/fft.py::fft_reference and
// ifft_reference) on its own.  Replaces specinv_tpu/ops/pallas/fft4.py
// fwd4_lane (:322) and inv4_real_lane (:367).
//
// What bounds it on an H100: forward plus inverse of 431 frames of 2048
// points read and write 3.5 MB each way (about 4.2 us at 3.35 TB/s for
// both) and do 2 x 2.5 N log2 N operations per frame (about 1.4 us at the
// FP64 rate), so device memory bounds it; 431 frames fill less than one wave
// of the 132 SMs, so a launch costs about one frame's latency, which the
// design cuts to ceil(log2(n/2) / 3) barriers per direction with the points
// in registers.  The forward reads the frame in its first stage and writes
// the onesided (or full) spectrum from its pair pass; the inverse builds the
// packed half-length spectrum in its pair pass (with all n bins: from the
// Hermitian part, which gives the real part of the full inverse) and writes
// the frame from its last stage.
#include <cuda_runtime.h>

#include "rfft.cuh"

namespace {

namespace rfft = specinv::rfft;

// The forward's first stage: point i of frame f is (x[2i], x[2i+1]).
struct RowIn {
  const float* x;  // the block's first row
  int n;
  __device__ __forceinline__ double2 operator()(int f, int i) const {
    const float* src = x + static_cast<size_t>(f) * n + 2 * i;
    return make_double2(src[0], src[1]);
  }
};

// The inverse's last stage: r[i] of frame f is x[2i] = Re, x[2i+1] = -Im,
// rounded to float32, times scale.
struct RowOut {
  float* out;  // the block's first row
  int n;
  float scale;
  __device__ __forceinline__ void operator()(int f, int i, double2 v) const {
    reinterpret_cast<float2*>(out + static_cast<size_t>(f) * n)[i] =
        make_float2(static_cast<float>(v.x) * scale, -static_cast<float>(v.y) * scale);
  }
};

// Bin v rounded to float32, times scale.
__device__ __forceinline__ float2 scaled(double2 v, float scale) {
  return make_float2(static_cast<float>(v.x) * scale, static_cast<float>(v.y) * scale);
}

template <bool ONESIDED>
__global__ void __launch_bounds__(256) fft_r2c_kernel(
    const float* __restrict__ x, float2* __restrict__ out, const double2* __restrict__ tw,
    int rows, int log2n, int n_bins, float scale) {
  extern __shared__ double2 smem_points[];
  const int log2h = log2n - 1, h = 1 << log2h, n = 2 * h;
  const int tpf = rfft::frame_threads(log2h), hp = rfft::padded(h);
  const int fpb = rfft::frames_per_block(log2h);
  double2* tw_s = smem_points;
  double2* buf = tw_s + h;
  const int row0 = blockIdx.x * fpb;
  const int nf = min(fpb, rows - row0);
  const int f = threadIdx.x / tpf, l = threadIdx.x & (tpf - 1);
  rfft::TwiddleCopy twc;
  twc.load(tw, h);  // stored after the first stage, which reads no twiddle
  double2* spec = buf + (rfft::stages(log2h) & 1 ? 0 : hp);
  rfft::fft_from(RowIn{x + static_cast<size_t>(row0) * n, n}, buf, buf + hp, 2 * hp, tw_s,
                 log2h, nf, rfft::Store{spec, 2 * hp}, [&]() { twc.store(tw_s, h); });
  __syncthreads();
  if (f >= nf) return;
  const double2* z = spec + 2 * f * hp;
  float2* o = out + static_cast<size_t>(row0 + f) * n_bins;
#pragma unroll
  for (int i = 0; i < rfft::kPairs; ++i) {
    const int k = l + i * tpf;
    if (k > h / 2) break;
    double2 zk, zc;
    rfft::split_forward(z[rfft::at(k)], z[rfft::at(k == 0 ? 0 : h - k)], tw_s[k], zk, zc);
    const float2 xk = scaled(zk, scale), xc = scaled(zc, scale);
    o[k] = xk;
    if (k != h / 2) o[h - k] = xc;
    if constexpr (!ONESIDED) {  // X[n - k] = conj(X[k])
      if (k != 0) {
        o[n - k] = make_float2(xk.x, -xk.y);
        if (k != h / 2) o[h + k] = make_float2(xc.x, -xc.y);
      }
    }
  }
}

template <bool ONESIDED>
__global__ void __launch_bounds__(256) fft_c2r_kernel(
    const float2* __restrict__ spec, float* __restrict__ out, const double2* __restrict__ tw,
    int rows, int log2n, int n_bins, float scale) {
  extern __shared__ double2 smem_points[];
  const int log2h = log2n - 1, h = 1 << log2h, n = 2 * h;
  const int tpf = rfft::frame_threads(log2h), hp = rfft::padded(h);
  const int fpb = rfft::frames_per_block(log2h);
  double2* tw_s = smem_points;
  double2* buf = tw_s + h;
  const int row0 = blockIdx.x * fpb;
  const int nf = min(fpb, rows - row0);
  const int f = threadIdx.x / tpf, l = threadIdx.x & (tpf - 1);
  rfft::TwiddleCopy twc;
  twc.load(tw, h);
  if (f < nf) {
    double2* z = buf + 2 * f * hp;
    const float2* s = spec + static_cast<size_t>(row0 + f) * n_bins;
#pragma unroll
    for (int i = 0; i < rfft::kPairs; ++i) {
      const int k = l + i * tpf;
      if (k > h / 2) break;
      float2 yk = s[k], yc = s[h - k];
      if constexpr (!ONESIDED) {  // the Hermitian parts (Y[k] + conj(Y[n - k])) / 2
        if (k != 0) {
          const float2 mk = s[n - k], mc = s[h + k];
          yk = make_float2(0.5f * (yk.x + mk.x), 0.5f * (yk.y - mk.y));
          yc = k == h / 2 ? yk : make_float2(0.5f * (yc.x + mc.x), 0.5f * (yc.y - mc.y));
        }
      }
      if (k == 0) {  // the inverse of a real frame reads only their real parts
        yk.y = 0.0f;
        yc.y = 0.0f;
      }
      double2 zk, zc;
      rfft::split_inverse(make_double2(yk.x, yk.y), make_double2(yc.x, yc.y), __ldg(tw + k), zk,
                          zc);
      z[rfft::at(k)] = zk;
      if (k != 0 && k != h / 2) z[rfft::at(h - k)] = zc;
    }
  }
  twc.store(tw_s, h);
  __syncthreads();
  rfft::fft_from(rfft::Load{buf, 2 * hp}, buf + hp, buf, 2 * hp, tw_s, log2h, nf,
                 RowOut{out + static_cast<size_t>(row0) * n, n, scale});
}

// Launch kernel over rows frames as rfft::frame_launch lays them out.
template <class Kernel, class... Args>
cudaError_t launch_rows(Kernel* kernel, int rows, int log2n, cudaStream_t stream, Args... args) {
  rfft::FrameLaunch fl;
  cudaError_t err = rfft::frame_launch(kernel, log2n - 1, &fl);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + fl.fpb - 1) / fl.fpb, fl.threads, fl.smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, n) real -> out (rows, n_bins) complex, n_bins = n/2+1 or n; tw
// the complex128 table of exp(-2 pi i j / n), j < n/2.
int specinv_fft_r2c(const float* x, float2* out, const double2* tw, int rows, int n, int log2n,
                    int n_bins, float scale, cudaStream_t stream) {
  const bool onesided = n_bins == n / 2 + 1;
  if (n != 1 << log2n || !(onesided || n_bins == n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = onesided ? fft_r2c_kernel<true> : fft_r2c_kernel<false>;
  return static_cast<int>(
      launch_rows(kernel, rows, log2n, stream, x, out, tw, rows, log2n, n_bins, scale));
}

// spec (rows, n_bins) complex -> out (rows, n) real part of the inverse DFT;
// onesided spectra are extended by Hermitian symmetry.  tw as above.
int specinv_fft_c2r(const float2* spec, float* out, const double2* tw, int rows, int n,
                    int log2n, int n_bins, int onesided, float scale, cudaStream_t stream) {
  if (n != 1 << log2n || n_bins != (onesided ? n / 2 + 1 : n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = onesided ? fft_c2r_kernel<true> : fft_c2r_kernel<false>;
  return static_cast<int>(
      launch_rows(kernel, rows, log2n, stream, spec, out, tw, rows, log2n, n_bins, scale));
}

const char* specinv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
