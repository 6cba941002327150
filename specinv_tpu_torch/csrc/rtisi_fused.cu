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
// Design.  One thread-block cluster per stream (launched with
// cudaLaunchKernelEx and a cluster dimension); each CTA of the cluster owns
// whole in-flight frames, frames_per_cta = ceil(R / 8) of them, so the
// cluster has ceil(R / frames_per_cta) <= 8 CTAs (the portable limit): at
// config 3 (la 3) four CTAs of one frame each.  The launch plan (cluster
// size, frames per CTA, frames per FFT pass, where the state lives, shared
// memory, threads) comes from the wrapper's rtisi_fused.plan, and the host
// entry checks it against the layout below.
//
// The state stays in shared memory across all k steps and refinements:
// each CTA holds a replica of every in-flight frame's upd (two buffers) and,
// for its own frames, the committed tail xk over the frame's samples, pre
// and the frame's target row; beside them the twiddles, the synthesis
// window and the FFT scratch.  Device memory is read at the launch's start
// and written at its end, and com once per step; the committed frames stay
// in device memory (nk of them, many at small hop) and are read once per
// step to form xk, never inside the refinement loop.  The in-flight frames
// form a ring: frame r of step s lives in slot (r + s) mod R, so the slide
// after a commit moves no data (the committed slot becomes the newest
// frame, whose upd counts as zero until its first refinement writes it),
// and the output is written back in frame order at the end.  Where the
// state does not fit in 227 KB (n_fft 4096, or many frames), the same state
// lives in this stream's slice of a device scratch, one copy of upd for the
// cluster, and the frames pass through shared memory `group` at a time for
// their FFTs.
//
// Overlap-add across the cluster through distributed shared memory: a
// frame's signal segment needs the upd of every frame within n_fft samples
// of it.  The inverse FFT's last stage stores each new upd value into the
// replica of every CTA of the cluster (cluster.map_shared_rank; remote
// stores do not wait), and one cluster barrier per refinement publishes
// them, so the gather reads only local shared memory; the two buffers keep a
// CTA from overwriting what a neighbour still reads.  No xs plane exists in
// device memory.
//
// Each real frame is transformed as an n/2-point complex FFT with the split
// post- and pre-passes of rfft.cuh, in radix-8/4/2 register stages with one
// barrier per stage, in FP64 (rfft.cuh says why); where n/2 = 2^a 3^b 5^c is
// no power of two (n_fft 400), the kernel's MIXED instance runs rfft.cuh's
// mixed-radix plan instead (n/2 = 200: one radix-8 and two radix-5 stages),
// and the power-of-two instance keeps the power-of-two stages (their shifts:
// the mixed plan's divisions took 243 against 184 us a step at n_fft 2048,
// 16 streams, on an H100 80GB HBM3 at 700 W); the split
// post-pass, momentum, projection and split pre-pass are one pass over the
// bin pairs (k, h - k), the gather writes the first stage's input and the
// last inverse stage writes upd.
//
// The arithmetic does not depend on k or on where a step sits in a launch:
// every step runs the same code on the same state, and the products and
// sums outside the FFT are rounded explicitly (__fmul_rn and friends are
// never contracted into an FMA), so k = 1, 3 or 8 and the streamer commit
// the same bits.
//
// What bounds it on an H100: at BASELINE config 3 (n 2048, hop 512, la 3,
// 25 refinements) one launch of k = 8 steps needs 8 x 25 x 4 frames of one
// real forward and one real inverse 2048-point FFT, 2.5 N log2 N flops each
// (90 MFLOP, in FP64 here), and the window, momentum, projection and OLA
// arithmetic beside them (18 MFLOP in FP32), against about 0.3 MB of input
// and output, so operations bound it.  Over the whole card (34 TFLOP/s FP64
// outside the tensor cores) the transforms take 2.7 us per stream and
// launch; over the 4 SMs of one stream's cluster (4/132 of the peak) about
// 10.9 us per step.  The earlier design had
// three limits: one block per stream (one SM at B = 1), the state and the
// OLA planes in device memory (every refinement rebuilt xs there and
// re-read the frames), and a complex FFT of each real frame in 11 radix-2
// stages with a barrier after each (about 24 barriers per refinement).  This
// one spreads a stream over R SMs, touches device memory only at the step
// boundaries, halves the FFT work, and waits at one cluster barrier and
// 2 ceil(log2(n/2) / 3) + 2 block barriers per refinement (10 at config 3).
// What is left is latency: each SM holds one frame, too little work to hide
// the shared-memory and barrier latency of a refinement's phases.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rfft.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kProjEps = 1e-16f;  // rtisi_la.py PROJ_EPS
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxThreads = 512;
constexpr int kPairs = 4;           // sample pairs per thread and frame in the gather

// Phase marks for scripts/torch_rtisi_phases.py, compiled in only with
// -DSPECINV_PHASE_MARKS: thread 0 of block 0 adds the clock64 cycles since
// its last mark to g_phase[i], which specinv_phase_read returns and clears.
#ifdef SPECINV_PHASE_MARKS
__device__ unsigned long long g_phase[8];
#define PHASE_START unsigned long long t_last = clock64();
#define PHASE_MARK(i)                                   \
  if (threadIdx.x == 0 && blockIdx.x == 0) {            \
    const unsigned long long t_ = clock64();            \
    g_phase[i] += t_ - t_last;                          \
    t_last = t_;                                        \
  }
#else
#define PHASE_START
#define PHASE_MARK(i)
#endif

struct Geometry {
  int B, k, R, nk, n, hop, max_iter;
  int cluster, fpc, group, resident;
  long long stride;  // floats of device scratch per stream (streamed state)
  float lr, fscale, iscale;
};

// Floats of state per frame in device memory (streamed state): upd (two
// buffers), xk, pre (complex), target.
__host__ __device__ inline int frame_floats(int n) { return 3 * n + 3 * (n / 2 + 1); }

// Floats of a CTA's resident state: the replica of every frame's upd (two
// buffers) and, for its own frames, xk, pre (complex) and the target row.
inline size_t resident_floats(int n, int R, int fpc) {
  return 2 * static_cast<size_t>(R) * n + static_cast<size_t>(fpc) * (n + 3 * (n / 2 + 1));
}

// Dynamic shared memory of a CTA: twiddles (n/2 complex FP64), the FFT
// scratch (two skewed buffers of n/2 complex FP64 per frame of a group), the
// synthesis window (n floats) and, when resident, the state of its frames.
// rtisi_fused.plan computes the same.
size_t shared_bytes(int n, int R, int fpc, int group, int resident) {
  size_t bytes = sizeof(double2) * (static_cast<size_t>(n) / 2 +
                                    2 * static_cast<size_t>(group) * specinv::rfft::padded(n / 2)) +
                 sizeof(float) * static_cast<size_t>(n);
  if (resident) bytes += resident_floats(n, R, fpc) * sizeof(float);
  return bytes;
}

// A complex FP64 value rounded to float32.
__device__ __forceinline__ float2 narrow(double2 v) {
  return make_float2(__double2float_rn(v.x), __double2float_rn(v.y));
}

// A load of upd from this CTA's replica (resident) or from device memory,
// past L1, where another CTA of the cluster wrote it.
__device__ __forceinline__ float ld(const float* p, int resident) {
  return resident ? *p : __ldcg(p);
}

// The inverse transform's epilogue: point m of frame f is the sample pair
// (2m, 2m + 1) of that frame's upd, times the inverse scale, stored in the
// replica of every CTA of the cluster (resident state: remote stores, which
// do not wait) or in the one copy in device memory.
struct WriteFrames {
  float* upd;  // the group's first frame, in this CTA's replica or in device memory
  int n;
  int copies;  // CTAs whose replicas receive it (this one's included); 0 or 1: just here
  float iscale;
  __device__ __forceinline__ void operator()(int f, int m, double2 v) const {
    const float2 r = narrow(v);
    const float2 out = make_float2(__fmul_rn(r.x, iscale), __fmul_rn(-r.y, iscale));
    float2* p = reinterpret_cast<float2*>(upd + static_cast<size_t>(f) * n) + m;
    *p = out;
    if (copies > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      const int me = static_cast<int>(cluster.block_rank());
      for (int c = 0; c < copies; ++c) {
        if (c != me) *cluster.map_shared_rank(p, c) = out;
      }
    }
  }
};

// Momentum and projection of one bin: v = x * fscale - lr * pre; pre = v;
// returns v * tgt / (|v| + eps).
__device__ __forceinline__ float2 middle(float2 x, float2* pre, float tgt, float lr,
                                         float fscale) {
  const float2 p = *pre;
  float2 v = make_float2(__fmul_rn(x.x, fscale), __fmul_rn(x.y, fscale));
  v.x = __fsub_rn(v.x, __fmul_rn(lr, p.x));
  v.y = __fsub_rn(v.y, __fmul_rn(lr, p.y));
  *pre = v;
  const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
  const float g = __fdiv_rn(tgt, __fadd_rn(mag, kProjEps));
  return make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
}

template <bool MIXED>
__global__ void __launch_bounds__(kMaxThreads, 1) rtisi_steps_kernel(
    float* keep,                         // (B, nk, n), updated in place
    float* upd,                          // (B, R, n), updated in place
    float2* pre,                         // (B, R, F), updated in place
    const float* __restrict__ target,    // (B, k + R - 1, F)
    const float* __restrict__ window,    // (n) analysis window
    const float* __restrict__ aw_first,  // (n) newest frame, refinement 0
    const float* __restrict__ aw_rest,   // (n) newest frame, refinements > 0
    const float* __restrict__ synth,     // (n) window * hop / sum(window^2)
    const double2* __restrict__ tw,      // (n/2) forward twiddles, float64
    float* com,                          // (k, B, n) committed frames
    float* scratch,                      // (B, stride) streamed state, or unused
    const Geometry g) {
  PHASE_START
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem[];
  const int n = g.n, h = n / 2, F = h + 1, R = g.R, hop = g.hop, nk = g.nk;
  // the transform's plan: log2h in the power-of-two instance, fp in the mixed one
  const int log2h = 31 - __clz(h);
  const specinv::rfft::Plan fp = MIXED ? specinv::rfft::plan(h) : specinv::rfft::Plan{};
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / g.cluster;
  const int p0 = rank * g.fpc;           // this CTA's first slot
  const int own = min(g.fpc, R - p0);    // its frames (the plan gives each CTA one or more)

  double2* tw_s = reinterpret_cast<double2*>(smem);
  double2* fft_s = tw_s + h;  // per frame of a group: two skewed buffers of h points
  const int hp = specinv::rfft::padded(h);
  float2* pre_s;
  float* rep_s[2];  // every frame's upd by slot: this CTA's replica, or device memory
  float* xk_s;
  float* tgt_s;
  int fi0;  // index of this CTA's first frame in its xk, pre and target arrays
  float* synth_s = reinterpret_cast<float*>(fft_s + 2 * g.group * hp);
  if (g.resident) {
    pre_s = reinterpret_cast<float2*>(synth_s + n);
    float* f = reinterpret_cast<float*>(pre_s + g.fpc * F);
    rep_s[0] = f;
    rep_s[1] = f + R * n;
    xk_s = f + 2 * R * n;
    tgt_s = xk_s + g.fpc * n;
    fi0 = 0;
  } else {
    float* base = scratch + static_cast<size_t>(b) * g.stride;
    pre_s = reinterpret_cast<float2*>(base);
    float* f = base + 2 * static_cast<size_t>(R) * F;
    rep_s[0] = f;
    rep_s[1] = f + static_cast<size_t>(R) * n;
    xk_s = f + 2 * static_cast<size_t>(R) * n;
    tgt_s = f + 3 * static_cast<size_t>(R) * n;
    fi0 = p0;
  }
  float* keep_b = keep + static_cast<size_t>(b) * nk * n;
  float* upd_b = upd + static_cast<size_t>(b) * R * n;
  float2* pre_b = pre + static_cast<size_t>(b) * R * F;
  const float* tgt_b = target + static_cast<size_t>(b) * (g.k + R - 1) * F;

  // frame r of step s lives in slot (r + s) mod R; slot p holds frame (p - s) mod R
  auto frame_of = [R](int p, int s) { return ((p - s) % R + R) % R; };
  // committed frame e of the extended sequence [keep, com[0], com[1], ...]
  auto committed = [&](int e, int o) -> float {
    return e < nk ? keep_b[static_cast<size_t>(e) * n + o]
                  : __ldcg(com + (static_cast<size_t>(e - nk) * g.B + b) * n + o);
  };

  for (int i = threadIdx.x; i < h; i += blockDim.x) tw_s[i] = tw[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) synth_s[i] = synth[i];
  // Load the frames (step 0: slot p holds frame p): all of them into this
  // CTA's replica, or its own into device memory; refinement 0 of step 0
  // takes the next frame's momentum.
  {
    const size_t q_hi = static_cast<size_t>(g.resident ? R : p0 + own) * n;
    for (size_t q = static_cast<size_t>(g.resident ? 0 : p0) * n + threadIdx.x; q < q_hi;
         q += blockDim.x) {
      rep_s[0][q] = upd_b[q];
    }
  }
  for (int q = threadIdx.x; q < own * F; q += blockDim.x) {
    const int l = q / F;
    const int p = p0 + l;
    pre_s[static_cast<size_t>(fi0) * F + q] =
        p + 1 < R ? pre_b[static_cast<size_t>(p + 1) * F + q - l * F] : make_float2(0.0f, 0.0f);
  }

  int cur = 0;  // the replica buffer that holds the current frames
  for (int s = 0; s < g.k; ++s) {
    const int s_mod = s % R;
    for (int j = 0; j < g.max_iter; ++j) {
      PHASE_MARK(6)
      cluster.sync();  // every replica's upd[cur] (and the last commit) is in place
      PHASE_MARK(0)
      if (j == 0) {
        // The committed tail over each own frame's samples (summed newest
        // frame first) and its target row.
        for (int q = threadIdx.x; q < own * n; q += blockDim.x) {
          const int l = q / n;
          const int i = q - l * n;
          const int pos = frame_of(p0 + l, s) * hop + i;
          float acc = 0.0f;
          if (pos < n) {
            for (int c = nk - 1; c >= max(0, nk - (n - 1 - pos) / hop); --c) {
              const int o = pos + (nk - c) * hop;
              acc = __fadd_rn(acc, __fmul_rn(committed(s + c, o), synth_s[o]));
            }
          }
          xk_s[static_cast<size_t>(fi0) * n + q] = acc;
        }
        for (int q = threadIdx.x; q < own * F; q += blockDim.x) {
          const int l = q / F;
          const int kb = q - l * F;
          tgt_s[static_cast<size_t>(fi0) * F + q] =
              tgt_b[static_cast<size_t>(s + frame_of(p0 + l, s)) * F + kb];
        }
        PHASE_MARK(1)
        __syncthreads();
      }
      const float* w_new = j == 0 ? aw_first : aw_rest;
      const float* src = rep_s[cur];
      float* dst = rep_s[cur ^ 1];
      const int bd = blockDim.x;
      // frame rr's upd in the current buffer
      auto upd_of = [&](int rr) -> const float* {
        const int p = rr + s_mod < R ? rr + s_mod : rr + s_mod - R;
        return src + static_cast<size_t>(p) * n;
      };
      const int reach = min(R - 1, (n - 1) / hop);  // frames a frame overlaps on each side
      // after a commit the newest frame's slot still holds the committed
      // frame: its upd is zero in refinement 0, so it adds nothing (adding
      // +0 to a sum that starts at +0 would not change its bits either)
      const int rr_top = j == 0 && s > 0 ? R - 2 : R - 1;

      for (int l0 = 0; l0 < own; l0 += g.group) {
        const int gn = min(g.group, own - l0);
        // Each frame's signal segment xs = xk + OLA(upd * synth), the OLA
        // summed newest frame first per sample and xk added last (the plain
        // version's order), windowed and packed two samples to a complex
        // point: a thread holds the pairs (2m, 2m + 1), m = tid + t bd
        // (t < kPairs), in registers and walks the overlapping frames once
        // each.
        for (int f = 0; f < gn; ++f) {
          const int l = l0 + f;
          const int r = frame_of(p0 + l, s);
          const float* w = r == R - 1 ? w_new : window;
          const float2* xk2 =
              reinterpret_cast<const float2*>(xk_s + static_cast<size_t>(fi0 + l) * n);
          float2 acc[kPairs];
#pragma unroll
          for (int t = 0; t < kPairs; ++t) acc[t] = make_float2(0.0f, 0.0f);
          for (int rr = min(rr_top, r + reach); rr >= max(0, r - reach); --rr) {
            const int off = (rr - r) * hop;  // frame rr covers samples [off, off + n)
            const int lo = max(0, off), hi = min(n, off + n);
            const float* u = upd_of(rr) - off;
            const float* sy = synth_s - off;
#pragma unroll
            for (int t = 0; t < kPairs; ++t) {
              const int i = 2 * (threadIdx.x + t * bd);
              if (i < n) {
                if (i >= lo && i < hi) {
                  acc[t].x = __fadd_rn(acc[t].x, __fmul_rn(ld(u + i, g.resident), sy[i]));
                }
                if (i + 1 >= lo && i + 1 < hi) {
                  acc[t].y = __fadd_rn(acc[t].y, __fmul_rn(ld(u + i + 1, g.resident), sy[i + 1]));
                }
              }
            }
          }
          double2* z = fft_s + 2 * f * hp;
#pragma unroll
          for (int t = 0; t < kPairs; ++t) {
            const int m = threadIdx.x + t * bd;
            if (m < h) {
              const float2 xs = make_float2(__fadd_rn(xk2[m].x, acc[t].x),
                                            __fadd_rn(xk2[m].y, acc[t].y));
              z[specinv::rfft::at(m)] = make_double2(__fmul_rn(xs.x, __ldg(w + 2 * m)),
                                                     __fmul_rn(xs.y, __ldg(w + 2 * m + 1)));
            }
          }
        }
        __syncthreads();
        PHASE_MARK(2)
        // the forward transform's result lands in the second buffer when
        // the stage count is odd, else in the first
        const int odd = (MIXED ? fp.count() : specinv::rfft::stages(log2h)) & 1;
        double2* spec = fft_s + odd * hp;
        if constexpr (MIXED) {
          specinv::rfft::fft_mixed(fft_s, fft_s + hp, tw_s, h, fp, gn, 2 * hp,
                                   specinv::rfft::Store{spec, 2 * hp});
        } else {
          specinv::rfft::fft(fft_s, fft_s + hp, tw_s, log2h, gn, 2 * hp,
                             specinv::rfft::Store{spec, 2 * hp});
        }
        __syncthreads();

        PHASE_MARK(3)
        // Split post-pass, momentum and projection, split pre-pass, over the
        // bin pairs (kk, h - kk); kk = 0 pairs DC with bin h, and kk = h/2 is
        // one bin, where h is even (the mixed instance also takes an odd h).
        for (int f = 0; f < gn; ++f) {
          double2* z = spec + f * 2 * hp;
          float2* pre_f = pre_s + static_cast<size_t>(fi0 + l0 + f) * F;
          const float* tgt_f = tgt_s + static_cast<size_t>(fi0 + l0 + f) * F;
          for (int kk = threadIdx.x; kk <= h / 2; kk += bd) {
            const int kc = kk == 0 ? 0 : h - kk;
            const double2 w = tw_s[kk];
            const bool pair = kk != h / 2 || (MIXED && (h & 1));
            double2 xk, xc;
            specinv::rfft::split_forward(z[specinv::rfft::at(kk)], z[specinv::rfft::at(kc)], w,
                                         xk, xc);
            // the middle in float32, on the bins rounded to float32
            float2 yk = middle(narrow(xk), pre_f + kk, tgt_f[kk], g.lr, g.fscale);
            float2 yc = yk;
            if (pair) {
              yc = middle(narrow(xc), pre_f + (h - kk), tgt_f[h - kk], g.lr, g.fscale);
            }
            if (kk == 0) {  // the inverse of a real frame reads only their real parts
              yk.y = 0.0f;
              yc.y = 0.0f;
            }
            double2 zk, zc;
            specinv::rfft::split_inverse(make_double2(yk.x, yk.y), make_double2(yc.x, yc.y), w,
                                         zk, zc);
            z[specinv::rfft::at(kk)] = zk;
            if (kk != 0 && pair) z[specinv::rfft::at(kc)] = zc;
          }
        }
        __syncthreads();
        PHASE_MARK(4)
        // the inverse transform's last stage writes the frames' new upd
        if constexpr (MIXED) {
          specinv::rfft::fft_mixed(spec, spec == fft_s ? fft_s + hp : fft_s, tw_s, h, fp, gn,
                                   2 * hp,
                                   WriteFrames{dst + static_cast<size_t>(p0 + l0) * n, n,
                                               g.resident ? g.cluster : 0, g.iscale});
        } else {
          specinv::rfft::fft(spec, spec == fft_s ? fft_s + hp : fft_s, tw_s, log2h, gn, 2 * hp,
                             WriteFrames{dst + static_cast<size_t>(p0 + l0) * n, n,
                                         g.resident ? g.cluster : 0, g.iscale});
        }
        __syncthreads();  // the next group reuses the FFT scratch
        PHASE_MARK(5)
      }
      cur ^= 1;
    }

    // Commit frame 0 (slot s mod R): its owner writes it to com.  The slot
    // becomes the newest frame, whose upd is zero until refinement 0 of the
    // next step writes it (that refinement leaves the slot's old values
    // out), and whose momentum is zero (except after the last step, whose
    // momentum is the output's).
    const int pc = s_mod;
    if (pc >= p0 && pc < p0 + own) {
      const float* u = rep_s[cur] + static_cast<size_t>(pc) * n;
      float* com_s = com + (static_cast<size_t>(s) * g.B + b) * n;
      for (int i = threadIdx.x; i < n; i += blockDim.x) com_s[i] = u[i];
      if (s + 1 < g.k) {
        float2* pf = pre_s + static_cast<size_t>(fi0 + pc - p0) * F;
        for (int q = threadIdx.x; q < F; q += blockDim.x) pf[q] = make_float2(0.0f, 0.0f);
      }
    }
  }

  cluster.sync();  // no CTA writes a neighbour's shared memory past here; com is written
  // Write back in frame order: upd after the last slide (slot p holds frame
  // (p - k) mod R; the newest, the last committed slot, is zero), pre as
  // the last step left it (frame (p - k + 1) mod R).
  for (int q = threadIdx.x; q < own * n; q += blockDim.x) {
    const int l = q / n;
    const int r = frame_of(p0 + l, g.k);
    upd_b[static_cast<size_t>(r) * n + q - l * n] =
        r == R - 1 ? 0.0f : rep_s[cur][static_cast<size_t>(p0) * n + q];
  }
  for (int q = threadIdx.x; q < own * F; q += blockDim.x) {
    const int l = q / F;
    pre_b[static_cast<size_t>(frame_of(p0 + l, g.k - 1)) * F + q - l * F] =
        pre_s[static_cast<size_t>(fi0) * F + q];
  }
  // The committed frames after k steps, [keep, com][k : k + nk], split over
  // the cluster by sample; one thread owns a sample across all frames, and
  // frame c reads frame k + c > c, so the in-place update has no hazard.
  for (int i = rank * blockDim.x + threadIdx.x; i < n; i += g.cluster * blockDim.x) {
    for (int c = 0; c < nk; ++c) keep_b[static_cast<size_t>(c) * n + i] = committed(g.k + c, i);
  }
}

}  // namespace

extern "C" {

// k RTISI-LA steps for B streams: keep, upd and pre are updated in place,
// com receives the committed frames.  The launch plan (cluster, fpc, group,
// resident, threads, smem, stride) is rtisi_fused.plan's; scratch holds
// B * stride floats when the state is not resident.  n/2 a power of two runs
// the power-of-two instance, n/2 = 2^a 3^b 5^c otherwise the mixed one.
// Returns the first CUDA error (0 if none); an odd n, an n/2 with another
// prime factor or a plan that does not match this layout is
// cudaErrorInvalidValue.
int specinv_rtisi_steps(float* keep, float* upd, float2* pre, const float* target,
                        const float* window, const float* aw_first, const float* aw_rest,
                        const float* synth, const double2* tw, float* com, float* scratch,
                        int B, int k, int R, int nk, int n, int hop, int max_iter,
                        int cluster, int fpc, int group, int resident, int threads, int smem,
                        long long stride, float lr, float fscale, float iscale,
                        cudaStream_t stream) {
  const specinv::rfft::Plan fp = specinv::rfft::plan(n / 2);
  if (n % 2 != 0 || !fp.valid() || cluster < 1 || cluster > kMaxCluster || fpc < 1 ||
      (cluster - 1) * fpc >= R || cluster * fpc < R || group < 1 || group > fpc ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || n / 2 > kPairs * threads ||
      shared_bytes(n, R, fpc, group, resident) != static_cast<size_t>(smem) ||
      (!resident && stride < static_cast<long long>(R) * frame_floats(n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = fp.mixed() ? rtisi_steps_kernel<true> : rtisi_steps_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const Geometry g{B, k, R, nk, n, hop, max_iter, cluster, fpc, group, resident, stride,
                   lr, fscale, iscale};
  err = cudaLaunchKernelEx(&config, kernel, keep, upd, pre, target, window, aw_first, aw_rest,
                           synth, tw, com, scratch, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SPECINV_PHASE_MARKS
int specinv_phase_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  const unsigned long long zero[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif

}  // extern "C"
