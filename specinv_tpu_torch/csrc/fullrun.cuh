// The iteration engine shared by the whole-run kernels (gl_fullrun.cu,
// admm_fullrun.cu): one iteration is a frame launch and an OLA launch.
//
// * frame_kernel<Middle, ONESIDED, MANY>: n/16 threads per frame, on the
//   plan the wrapper chose (rfft.cuh): one frame per block, or as many as
//   make a whole warp below n_fft 512 (rfft::frame_launch), or (MANY) twice
//   that, in place (rfft::frame_launch's in_place).  Each frame is
//   transformed as a half-length complex FFT in FP64 (rfft.cuh): the first
//   radix-8 stage reads the windowed frame straight from x_pad, packed as
//   z[m] = x[2m] + i x[2m+1]; after the forward stages one pair pass over
//   the bin pairs (k, h - k), h = n/2, does everything between the two
//   transforms in registers: the split post-pass, the forward scale, the
//   eval output on the last iteration of an eval segment (the magnitude
//   plane, or per-frame partial sums of (|S|-tgt)^2 and |S|^2 over the
//   stored bins of the first valid_t frames), the algorithm's Middle on
//   each stored bin (which updates the state plane in place and returns the
//   spectrum to invert) and the split pre-pass; the inverse stages' last
//   one writes the windowed frame to a (B, T, n_fft) scratch.  The state is
//   stored in natural bin order as complex64, onesided (bins 0 .. h) or
//   with all n bins; a thread loads the operands of all its pairs (state,
//   target and split twiddles) at once, one round trip to device memory
//   (MANY: in two groups, from L2).
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
//
// With all n bins stored (onesided false), Middle runs on bins k and n - k
// separately, each with its own state, and the inverse takes the Hermitian
// part (P[k] + conj(P[n-k])) / 2 of its result P: the real part of the full
// inverse, which is what the frame keeps.  The imaginary parts of the DC
// and Nyquist bins are dropped going into the inverse (exact: the real part
// of the inverse drops them).
//
// What bounds it on an H100, and what the design does about it.  At config
// 1 (n_fft 2048, hop 512, 431 frames) the frames fill less than one wave of
// the 132 SMs, so an iteration costs about one frame's latency: the design
// halves the transform work (a real frame as a half-length complex one),
// keeps a butterfly's 8 points in registers and waits at 2 (S - 1) + 2 block
// barriers per frame (S = ceil(log2(n/2) / 3) stages: 8 at n_fft 2048,
// against about 25 for 11 radix-2 stages and a permutation each way), reads
// the frame from device memory in the first stage and writes it from the
// last.  Launches of many waves (64 clips: 27584 frames; the seq path's
// 25843) take the many-wave plan of rfft.cuh: two frames a block in place,
// six frames an SM at n_fft 2048 against four.  Each plane is read and
// written once (at 27584 frames the state plane 226 MB, the target 113 MB,
// x_pad 57 MB, the frame scratch 226 MB: about 0.25 ms at 3.35 TB/s), and
// what holds the launch above that (0.51-0.56 ms) is the SM's shared-memory
// and L1 data path: every stage loads and stores each point once in shared
// memory, beside the twiddle loads and the frame's global loads and stores.
// More frames an SM hide less than they add there: at 64 registers a thread
// (eight frames) the stages spill and run slower than four frames.  The
// pair pass loads its operands in two groups, from rows that a bulk L2
// prefetch at the kernel's start has fetched while the forward stages ran.
#pragma once

#include <cuda_runtime.h>

#include "rfft.cuh"

namespace specinv {
namespace {

constexpr float kProjEps = 1e-16f;  // griffin_lim.py:38 PROJ_EPS

enum PadMode { kConstant = 0, kReflect = 1, kReplicate = 2, kCircular = 3 };

// The sum of v over the warp, or over each aligned group of `lanes` (a
// power of two <= 32) lanes of it; every lane of the warp calls it.
__device__ __forceinline__ float warp_sum(float v, int lanes = 32) {
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The first stage's input: point i of frame f of the block's frames (rows
// row0 + f of the flattened (B, T)) is (x[2i] w[2i], x[2i+1] w[2i+1]) of
// that frame's window of x_pad (float32 products, widened to FP64).
struct FrameIn {
  const float* x_pad;
  const float* window;
  int row0, T, hop, lp;
  __device__ __forceinline__ double2 operator()(int f, int i) const {
    const int row = row0 + f;
    const int b = row / T;
    const float* src = x_pad + static_cast<size_t>(b) * lp +
                       static_cast<size_t>(row - b * T) * hop + 2 * i;
    return make_double2(src[0] * __ldg(window + 2 * i), src[1] * __ldg(window + 2 * i + 1));
  }
};

// The inverse's last stage: r[i] of frame f is x[2i] = Re, x[2i+1] = -Im,
// rounded to float32, times iscale and the window, stored to the frame
// scratch.
struct FrameOut {
  float* out;  // the block's first frame
  const float* window;
  float iscale;
  int n;
  __device__ __forceinline__ void operator()(int f, int i, double2 v) const {
    reinterpret_cast<float2*>(out + static_cast<size_t>(f) * n)[i] =
        make_float2(static_cast<float>(v.x) * iscale * __ldg(window + 2 * i),
                    -static_cast<float>(v.y) * iscale * __ldg(window + 2 * i + 1));
  }
};

// The 16-byte chunks of [p, p + bytes) fetched into L2 by one bulk prefetch,
// which holds no registers.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const size_t a = (reinterpret_cast<size_t>(p) + 15) & ~size_t{15};
  const size_t b = (reinterpret_cast<size_t>(p) + bytes) & ~size_t{15};
  if (b > a) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a),
                 "r"(static_cast<unsigned>(b - a))
                 : "memory");
  }
}

// The bins of pair k (0 <= k <= h/2) and whether each is its own: k and
// h - k, and with all n bins stored n - k and h + k.  At k = 0 the pair is
// DC and Nyquist (n - 0 and h + 0 repeat them); at k = h/2 it is one bin
// (and its mirror 3h/2).
template <bool ONESIDED>
struct PairBins {
  static constexpr int count = ONESIDED ? 2 : 4;
  int bin[count];
  bool own[count];
  __device__ __forceinline__ PairBins(int k, int h) {
    bin[0] = k;
    own[0] = true;
    bin[1] = h - k;
    own[1] = k != h / 2;
    if constexpr (!ONESIDED) {
      bin[2] = (2 * h - k) & (2 * h - 1);
      own[2] = k != 0;
      bin[3] = h + k;
      own[3] = k != 0 && k != h / 2;
    }
  }
};

// MANY: the many-wave plan (rfft.cuh).  Its bound of 80 registers a thread
// lets an SM hold three blocks of 256 threads (six frames at n_fft 2048);
// at 64, for four, the stages spill and run slower than the one-wave plan.
template <class Middle, bool ONESIDED, bool MANY>
__global__ void __launch_bounds__(MANY ? 768 : 256, 1) frame_kernel(
    const float* __restrict__ x_pad,     // (B, lp)
    float2* __restrict__ state,          // (B, T, F) state, updated in place
    const float* __restrict__ target,    // (B, T, F)
    const float* __restrict__ window,    // (n)
    const double2* __restrict__ tw,      // (n/2) forward twiddles
    float* __restrict__ frames,          // (B, T, n) windowed output frames
    float* __restrict__ mag,             // (B, T, F) or null
    float* __restrict__ stats,           // (B, T, 2) or null
    int rows, int T, int log2n, int hop, int n_bins, int lp, float fscale, float iscale,
    int valid_t, Middle middle) {
  using PB = PairBins<ONESIDED>;
  extern __shared__ double2 smem_points[];
  __shared__ float red[2][32];
  const int log2h = log2n - 1, h = 1 << log2h, n = 2 * h;
  const int tpf = rfft::frame_threads(log2h), hp = rfft::padded(h);
  const int fpb = (MANY ? 2 : 1) * rfft::frames_per_block(log2h);
  double2* tw_s = smem_points;
  double2* buf = tw_s + h;  // frame f: buf + 2 f hp, two buffers (MANY: buf + f hp, one)
  const int row0 = blockIdx.x * fpb;
  const int nf = min(fpb, rows - row0);  // frames of this block
  // this thread's frame and its lane in the pair pass
  const int f = threadIdx.x / tpf, l = threadIdx.x & (tpf - 1);
  const bool live = f < nf;
  const int row = row0 + f;
  const int t = row % T;
  const size_t plane = static_cast<size_t>(row) * n_bins;
  const FrameIn frame_in{x_pad, window, row0, T, hop, lp};
  const rfft::FrameSync frame_sync{tpf};

  // the forward transform; the spectrum of frame f lands in z
  double2* z;
  double2* spec = buf;
  if constexpr (MANY) {
    z = buf + f * hp;
    if (live && l == 0) {  // the pair pass's rows, into L2 while the forward stages run
      prefetch_l2(state + plane, sizeof(float2) * n_bins);
      prefetch_l2(target + plane, sizeof(float) * n_bins);
    }
    rfft::copy_twiddles(tw_s, tw, h);  // waited for after the first stage, which reads none
    rfft::fft_frame<false, true>(frame_in, z, tw_s, log2h, f, l, live, rfft::FrameStore{z},
                                 frame_sync, [&]() {
                                   rfft::wait_copies();
                                   __syncthreads();
                                 });
    frame_sync();
  } else {
    rfft::TwiddleCopy twc;
    twc.load(tw, h);  // stored after the first stage, which reads no twiddle
    // the spectrum lands in the first buffer when the stage count is odd,
    // else in the second
    spec = buf + (rfft::stages(log2h) & 1 ? 0 : hp);
    z = spec + 2 * f * hp;
    rfft::fft_from(frame_in, buf, buf + hp, 2 * hp, tw_s, log2h, nf, rfft::Store{spec, 2 * hp},
                   [&]() { twc.store(tw_s, h); });
    __syncthreads();
  }

  // The pair pass: split post-pass, scale, eval output, Middle, split
  // pre-pass, in place (the thread of pair k alone reads and writes its
  // two points).  The state, target and split twiddles of a group of its
  // pairs are loaded first (one round trip a group): all of them, or
  // (MANY) three and then two, which the register budget holds.
  constexpr int kGroup = MANY ? 3 : rfft::kPairs;
  float l0 = 0.0f, l1 = 0.0f;
  const bool valid = t < valid_t;
  const bool in_sums = stats != nullptr && valid;
  if (live) {
#pragma unroll
  for (int i0 = 0; i0 < rfft::kPairs; i0 += kGroup) {
    float2 st[rfft::kPairs][PB::count];
    float tg[rfft::kPairs][PB::count];
    double2 wk[rfft::kPairs];
#pragma unroll
    for (int i = i0; i < i0 + kGroup && i < rfft::kPairs; ++i) {
      const int k = l + i * tpf;
      if (k <= h / 2) {
        const PB pb(k, h);
        if constexpr (!MANY) wk[i] = __ldg(tw + k);  // MANY: read where used, from tw_s
#pragma unroll
        for (int j = 0; j < PB::count; ++j) {
          if (pb.own[j]) {
            st[i][j] = state[plane + pb.bin[j]];
            tg[i][j] = __ldg(target + plane + pb.bin[j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = i0; i < i0 + kGroup && i < rfft::kPairs; ++i) {
      const int k = l + i * tpf;
      if (k <= h / 2) {
        const PB pb(k, h);
        const int kc = k == 0 ? 0 : h - k;
        double2 zk, zc;
        const double2 w = MANY ? tw_s[rfft::swizzled(k)] : wk[i];  // the same table, copied
        rfft::split_forward(z[rfft::at(k)], z[rfft::at(kc)], w, zk, zc);
        // Bins rounded to float32, then rounded products (__fmul_rn is never
        // fused into an FMA): where the eval branch below is skipped, the
        // compiler could otherwise fold the scaling into the middle's first
        // FMA, and an eval iteration would then round differently from the
        // others.
        const float2 xk = make_float2(__fmul_rn(static_cast<float>(zk.x), fscale),
                                      __fmul_rn(static_cast<float>(zk.y), fscale));
        const float2 xc = make_float2(__fmul_rn(static_cast<float>(zc.x), fscale),
                                      __fmul_rn(static_cast<float>(zc.y), fscale));
        float2 p[PB::count];
#pragma unroll
        for (int j = 0; j < PB::count; ++j) {
          if (!pb.own[j]) continue;
          const float2 x = j & 1 ? xc : xk;
          const float2 v = j < 2 ? x : make_float2(x.x, -x.y);  // X[n-k] = conj(X[k])
          const size_t idx = plane + pb.bin[j];
          if (mag != nullptr || in_sums) {
            const float m = sqrtf(v.x * v.x + v.y * v.y);
            if (mag != nullptr) mag[idx] = m;
            if (in_sums) {
              const float d = m - tg[i][j];
              l0 += d * d;
              l1 += m * m;
            }
          }
          p[j] = middle(v, st[i][j], tg[i][j], valid);
          state[idx] = st[i][j];
        }
        float2 yk = p[0], yc = pb.own[1] ? p[1] : p[0];
        if constexpr (!ONESIDED) {  // the Hermitian parts
          if (k != 0) {
            yk = make_float2(0.5f * (p[0].x + p[2].x), 0.5f * (p[0].y - p[2].y));
            yc = pb.own[1] ? make_float2(0.5f * (p[1].x + p[3].x), 0.5f * (p[1].y - p[3].y))
                           : yk;
          }
        }
        if (k == 0) {  // the inverse of a real frame reads only their real parts
          yk.y = 0.0f;
          yc.y = 0.0f;
        }
        rfft::split_inverse(make_double2(yk.x, yk.y), make_double2(yc.x, yc.y), w, zk, zc);
        z[rfft::at(k)] = zk;
        if (k != 0 && k != h / 2) z[rfft::at(kc)] = zc;
      }
    }
  }
  }

  // per-frame eval sums: the frame's lanes of a warp by shuffles, then (a
  // frame over several warps) its warps in order
  if (stats != nullptr) {
    l0 = warp_sum(l0, min(tpf, 32));
    l1 = warp_sum(l1, min(tpf, 32));
    if (tpf <= 32) {
      if (live && l == 0) {
        stats[static_cast<size_t>(row) * 2] = l0;
        stats[static_cast<size_t>(row) * 2 + 1] = l1;
      }
    } else if ((threadIdx.x & 31) == 0) {
      red[0][threadIdx.x >> 5] = l0;
      red[1][threadIdx.x >> 5] = l1;
    }
  }
  if constexpr (MANY) {
    frame_sync();
  } else {
    __syncthreads();
  }
  if (stats != nullptr && tpf > 32 && live && l == 0) {
    float a = 0.0f, c = 0.0f;
    for (int w = threadIdx.x >> 5; w < (threadIdx.x + tpf) >> 5; ++w) {
      a += red[0][w];
      c += red[1][w];
    }
    stats[static_cast<size_t>(row) * 2] = a;
    stats[static_cast<size_t>(row) * 2 + 1] = c;
  }

  // the inverse transform; its last stage writes the windowed frames
  const FrameOut frame_out{frames + static_cast<size_t>(row0) * n, window, iscale, n};
  if constexpr (MANY) {
    rfft::fft_frame<true, false>(rfft::FrameLoad{z}, z, tw_s, log2h, f, l, live, frame_out,
                                 frame_sync, frame_sync);
  } else {
    rfft::fft_from(rfft::Load{spec, 2 * hp}, spec == buf ? buf + hp : buf, spec, 2 * hp, tw_s,
                   log2h, nf, frame_out);
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

// One iteration: x_in -> x_out (distinct buffers), state updated in place,
// the frame launch on the plan (fpb, threads, smem).  mag and stats may be
// null.  Returns the first launch error (0 if none).
template <class Middle>
int run_iteration(const float* x_in, float* x_out, float2* state,
                  const float* target, const float* window, const double2* tw,
                  const float* inv_env, float* frames, float* mag,
                  float* stats, int B, int T, int n, int log2n, int hop,
                  int n_bins, int lp, int onesided, int p_amt, int e,
                  int pad_mode, float fscale, float iscale, int valid_t,
                  int fpb, int threads, int smem, Middle middle, cudaStream_t stream) {
  if (log2n < 4 || log2n > 12 || n != 1 << log2n || n_bins != (onesided ? n / 2 + 1 : n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the plan the wrapper chose (ops/cuda/_fullrun.frame_plan): the one-wave
  // layout of rfft.cuh or the many-wave one, anything else refused
  const int rows = B * T, log2h = log2n - 1;
  const bool in_place = fpb != rfft::frames_per_block(log2h);
  auto* kernel = in_place ? (onesided ? frame_kernel<Middle, true, true>
                                      : frame_kernel<Middle, false, true>)
                          : (onesided ? frame_kernel<Middle, true, false>
                                      : frame_kernel<Middle, false, false>);
  rfft::FrameLaunch fl;
  cudaError_t err = rfft::frame_launch(kernel, log2h, &fl, in_place);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fl.fpb != fpb || fl.threads != threads || fl.smem != static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<(rows + fpb - 1) / fpb, threads, fl.smem, stream>>>(
      x_in, state, target, window, tw, frames, mag, stats, rows, T, log2n, hop, n_bins, lp,
      fscale, iscale, valid_t, middle);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ola_threads = 256;
  const size_t total = static_cast<size_t>(B) * lp;
  const unsigned blocks = static_cast<unsigned>((total + ola_threads - 1) / ola_threads);
  ola_kernel<<<blocks, ola_threads, 0, stream>>>(frames, inv_env, x_out, B, T, n,
                                                 hop, lp, p_amt, e, pad_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace specinv
