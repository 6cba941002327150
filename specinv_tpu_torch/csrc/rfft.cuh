// Real FFT at half length for the port's kernels: an n-point real frame
// transformed as an h = n/2-point complex FFT in Stockham radix-8/4/2 stages
// (and, for D off the powers of two, radix-5/3 ones) held in registers, with
// the standard split passes around it, in FP64.
// The RTISI kernel D (rtisi_fused.cu), the whole-run kernels A and C
// (fullrun.cuh) and the stand-alone transform B (fft.cu) run it.
//
// Replaces the TPU four-step transform specinv_tpu/ops/pallas/fft4.py
// (fwd4_lane :322, inv4_real_lane :367, fwd4 :250, inv4_real :280), which
// the whole-run TPU kernels inline.  The TPU version factors N = m*128 so
// its two 128-deep stages ride the 128x128 matrix unit in bf16x3 split dots
// and keeps the spectrum in a permuted (m, 128) order.  None of that carries
// over: on the CUDA cores a transform of one frame is bound by the latency
// of its shared-memory round trips and barriers, so this one halves the work
// (a real frame as a half-length complex one), keeps each butterfly's points
// in registers and waits at one barrier per radix-8 stage, in natural bin
// order.
//
// Forward: the frame x (n real points) is packed as z[m] = x[2m] + i x[2m+1]
// (m < h), Z = FFT_h(z), and the split post-pass gives the onesided
// spectrum X[k], k = 0 .. h, from Z[k] and Z[h-k] (split_forward).  Inverse:
// the split pre-pass packs a onesided spectrum Y into Z'[k] (split_inverse),
// whose unscaled inverse h-point DFT is n (x[2m] + i x[2m+1]); it returns
// conj(Z'), so the same forward stages compute the inverse, and the caller
// reads x[2m] = Re r[m], x[2m+1] = -Im r[m] (times its scale).  Like numpy's
// irfft and cuFFT's C2R, the inverse ignores the imaginary parts of Y[0] and
// Y[h]: the caller zeroes them.
//
// Stages: Stockham autosort (Govindaraju et al., SC 2008), natural order in
// and out, out of place between two buffers of h points per frame, radix 8
// while three or more factors of two remain, then one radix-4 or radix-2
// stage.  A thread loads one butterfly's R points, twiddles them, runs the
// R-point DFT in registers and stores them; the block waits at one barrier
// per stage (ceil(log2(h) / 3) stages, 4 at h = 1024, against 11 radix-2
// stages and a permutation in a complex n-point transform).  The first stage
// may read its points from anywhere (fft_from: the whole-run kernels read
// the windowed frame straight from device memory), and the last stage hands
// its outputs to the caller's epilogue instead of a buffer.
//
// Precision: the points, twiddles and arithmetic are FP64 (the caller
// rounds what goes in and comes out to float32), so the transform adds
// about 1e-16 of relative error where a float32 FFT adds about 1e-7.
// RTISI-LA's refinements amplify rounding in the bins where |S| is small:
// with a float32 transform as accurate as cuFFT's, the RTISI kernel lay as
// far from a float64 run as the float32 plain version; with this one it
// lies about ten times closer at config 3 (chip_smoke's readings).  ADMM's
// dual integrates rounding too: a float32 instance of these stages in A and
// C missed one limit of chip_smoke.py, the sequence-parallel ADMM at world
// 1 against the unsharded call, which this one meets.  The card's FP64 rate
// is half its FP32 rate, and these transforms are bound by latency and
// barriers, not by operations.
//
// Mixed radix (kernel D alone): where h = n/2 = 2^a 3^b 5^c is no power of
// two (n_fft 400: h = 200), fft_mixed runs the same Stockham stages after
// the plan of plan(h): radix 8 while three or more factors of two remain,
// then one radix-4 or radix-2 stage (the power-of-two plan), then a radix-5
// stage per factor of five and a radix-3 stage per factor of three.  Its
// index and twiddle arithmetic take a stage's stride and span as integers
// (divisions where the power-of-two stages shift); at a power of two the
// plan is the power-of-two one, whose stages A, B, C and D keep running.
//
// Layout: a buffer of h points keeps point i at at(i) = i + i / 8 (one
// padding point after every eight), so that the first stage's stores, eight
// points apart across threads, fall in distinct banks; buffers are
// padded(h) points long.  A mixed plan keeps it: where 8 divides h, the
// radix-5 and radix-3 stages, which follow the radix-8 one, load and store
// runs of eight consecutive points aligned to eight, which it leaves on
// distinct banks, and only the first stage's loads (runs at offsets r h / 8)
// can meet one bank twice.
//
// Twiddles: tw[j] = exp(-2 pi i j / n), j < n/2, computed in float64 on the
// host and kept in float64, here read from shared memory: exp(-2 pi i m / h)
// is tw[2m], or -tw[2m - h] past a half turn; a butterfly reads w = w^1 and
// forms w^2 .. w^(R-1) by products (FP64: each adds about 1e-16), and the
// split passes take exp(-2 pi i k / n) = tw[k] directly.  The frame kernels
// of A, B and C copy tw into shared memory once per block.  A per-stage
// table of every power, read without bank conflicts, gave the same bits
// after the float32 rounding of the outputs and ran slower on an H100: the
// products cost less than the table's extra shared-memory reads.  The same
// code on the same inputs gives the same bits wherever it runs.
#pragma once

#include <cuda_runtime.h>

namespace specinv {
namespace rfft {

__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ double2 mul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ double2 mul_conj(double2 a, double2 b) {
  return make_double2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// -i * a
__device__ __forceinline__ double2 mul_neg_i(double2 a) { return make_double2(a.y, -a.x); }

// The skewed position of point i in a buffer, and a buffer's length.
__host__ __device__ __forceinline__ int at(int i) { return i + (i >> 3); }
__host__ __device__ __forceinline__ int padded(int h) { return h + (h >> 3); }

// exp(-2 pi i m / h), m < h, from the n/2-entry table of exp(-2 pi i j / n)
__device__ __forceinline__ double2 twiddle(const double2* tw, int m, int h) {
  const int j = 2 * m;
  if (j < h) return tw[j];
  const double2 t = tw[j - h];
  return make_double2(-t.x, -t.y);
}

// R-point forward DFTs in registers, natural order in and out.
__device__ __forceinline__ void dft2(double2* v) {
  const double2 a = v[0];
  v[0] = add(a, v[1]);
  v[1] = sub(a, v[1]);
}

__device__ __forceinline__ void dft4(double2& v0, double2& v1, double2& v2, double2& v3) {
  const double2 t0 = add(v0, v2), t1 = sub(v0, v2);
  const double2 t2 = add(v1, v3), t3 = mul_neg_i(sub(v1, v3));
  v0 = add(t0, t2);
  v2 = sub(t0, t2);
  v1 = add(t1, t3);
  v3 = sub(t1, t3);
}

__device__ __forceinline__ void dft8(double2* v) {
  constexpr double c = 0.70710678118654752440;  // cos(pi / 4)
  double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  double2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  // X[k] = E[k] + W8^k O[k], X[k + 4] = E[k] - W8^k O[k], W8 = exp(-i pi / 4)
  o1 = make_double2(c * (o1.x + o1.y), c * (o1.y - o1.x));
  o2 = mul_neg_i(o2);
  o3 = make_double2(c * (o3.y - o3.x), -c * (o3.x + o3.y));
  v[0] = add(e0, o0);
  v[4] = sub(e0, o0);
  v[1] = add(e1, o1);
  v[5] = sub(e1, o1);
  v[2] = add(e2, o2);
  v[6] = sub(e2, o2);
  v[3] = add(e3, o3);
  v[7] = sub(e3, o3);
}

// X[k] = sum_m v[m] W^(m k), W = exp(-2 pi i / 3)
__device__ __forceinline__ void dft3(double2* v) {
  constexpr double s = 0.86602540378443864676;  // sin(2 pi / 3)
  const double2 t = add(v[1], v[2]);
  const double2 m = make_double2(v[0].x - 0.5 * t.x, v[0].y - 0.5 * t.y);
  const double2 d = mul_neg_i(make_double2(s * (v[1].x - v[2].x), s * (v[1].y - v[2].y)));
  v[0] = add(v[0], t);
  v[1] = add(m, d);
  v[2] = sub(m, d);
}

// X[k] = sum_m v[m] W^(m k), W = exp(-2 pi i / 5), from the sums and
// differences of the points m and 5 - m.
__device__ __forceinline__ void dft5(double2* v) {
  constexpr double c1 = 0.30901699437494742410;   // cos(2 pi / 5)
  constexpr double c2 = -0.80901699437494742410;  // cos(4 pi / 5)
  constexpr double s1 = 0.95105651629515357212;   // sin(2 pi / 5)
  constexpr double s2 = 0.58778525229247312917;   // sin(4 pi / 5)
  const double2 a1 = add(v[1], v[4]), b1 = sub(v[1], v[4]);
  const double2 a2 = add(v[2], v[3]), b2 = sub(v[2], v[3]);
  const double2 m1 = make_double2(v[0].x + c1 * a1.x + c2 * a2.x, v[0].y + c1 * a1.y + c2 * a2.y);
  const double2 m2 = make_double2(v[0].x + c2 * a1.x + c1 * a2.x, v[0].y + c2 * a1.y + c1 * a2.y);
  // -i (s1 b1 + s2 b2) and -i (s2 b1 - s1 b2)
  const double2 d1 = mul_neg_i(make_double2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y));
  const double2 d2 = mul_neg_i(make_double2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y));
  v[0] = add(v[0], add(a1, a2));
  v[1] = add(m1, d1);
  v[4] = sub(m1, d1);
  v[2] = add(m2, d2);
  v[3] = sub(m2, d2);
}

template <int R>
__device__ __forceinline__ void dft(double2* v) {
  if constexpr (R == 8) {
    dft8(v);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 5) {
    dft5(v);
  } else if constexpr (R == 3) {
    dft3(v);
  } else {
    dft2(v);
  }
}

// Stages of an h-point FFT: radix 8 while three or more factors of two
// remain, then one radix-4 or radix-2 stage.
__host__ __device__ __forceinline__ int stages(int log2h) { return (log2h + 2) / 3; }

// A stage's input: point i of frame f of a (skewed) buffer whose frames lie
// `stride` points apart.
struct Load {
  const double2* src;
  int stride;
  __device__ __forceinline__ double2 operator()(int f, int i) const {
    return src[f * stride + at(i)];
  }
};

// A stage's output: point i of frame f stored (skewed) in such a buffer.
struct Store {
  double2* dst;
  int stride;
  __device__ __forceinline__ void operator()(int f, int i, double2 v) const {
    dst[f * stride + at(i)] = v;
  }
};

// w^1 .. w^(R-1) from w, by products in a tree of depth 3 (w^2, w^4 and the
// odd powers from them).
template <int R>
__device__ __forceinline__ void powers(double2 w, double2* wr) {
  wr[1] = w;
  if constexpr (R > 2) wr[2] = mul(w, w);
  if constexpr (R > 3) wr[3] = mul(wr[2], w);
  if constexpr (R > 4) wr[4] = mul(wr[2], wr[2]);
  if constexpr (R > 5) {
    wr[5] = mul(wr[4], w);
    wr[6] = mul(wr[4], wr[2]);
    wr[7] = mul(wr[4], wr[3]);
  }
}

// No work: fft_from's default after_first.
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// One Stockham stage of radix R over `frames` frames of h = 2^log2h points
// read as in(f, i); ns = 2^log2ns is the product of the earlier stages'
// radices.  Output point i of frame f goes to out(f, i, value).  No barrier.
template <int R, class In, class Out>
__device__ __forceinline__ void stage(const In& in, const double2* tw, int log2h, int log2ns,
                                      int frames, const Out& out) {
  constexpr int log2r = R == 8 ? 3 : (R == 4 ? 2 : 1);
  const int h = 1 << log2h;
  const int log2nb = log2h - log2r;  // butterflies per frame: h / R
  const int ns = 1 << log2ns;
  const int tstep = log2h - log2ns - log2r;  // twiddle index k * h / (ns * R)
  for (int q = threadIdx.x; q < frames << log2nb; q += blockDim.x) {
    const int f = q >> log2nb;
    const int j = q & ((1 << log2nb) - 1);
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in(f, j + (r << log2nb));
    const int k = j & (ns - 1);
    if (ns > 1) {
      double2 wr[R];
      powers<R>(twiddle(tw, k << tstep, h), wr);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = mul(v[r], wr[r]);
    }
    dft<R>(v);
    const int base = ((j - k) << log2r) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out(f, base + (r << log2ns), v[r]);
  }
}

template <class In, class Out>
__device__ __forceinline__ void run_stage(int log2r, const In& in, const double2* tw, int log2h,
                                          int log2ns, int frames, const Out& out) {
  if (log2r == 3) {
    stage<8>(in, tw, log2h, log2ns, frames, out);
  } else if (log2r == 2) {
    stage<4>(in, tw, log2h, log2ns, frames, out);
  } else {
    stage<2>(in, tw, log2h, log2ns, frames, out);
  }
}

// Forward h-point complex FFT (unscaled) of `frames` frames, the twiddles
// from tw (n/2 entries, shared memory): the first stage reads first(f, i);
// stage s < S = stages(log2h) stores to a when s is odd, else to b (the
// frames `stride` points apart), and the stage after it reads that buffer;
// the last stage hands its outputs to last(f, i, value), so a Store keeps
// them in a when S is odd, else in b (never the buffer the last stage
// reads).  The first stage reads no twiddle, and after_first() runs right
// after it, before the barrier that follows it (the whole-run kernels store
// tw there).  Waits at one barrier after each stage but the last: the caller
// provides any barrier the first stage's input needs, and the one after the
// last stage.
template <class First, class Last, class Hook = NoHook>
__device__ inline void fft_from(const First& first, double2* a, double2* b, int stride,
                                const double2* tw, int log2h, int frames, const Last& last,
                                const Hook& after_first = Hook{}) {
  int bits = log2h, log2r = bits >= 3 ? 3 : bits;
  if (log2r == bits) {
    run_stage(log2r, first, tw, log2h, 0, frames, last);
    after_first();
    return;
  }
  run_stage(log2r, first, tw, log2h, 0, frames, Store{a, stride});
  after_first();
  __syncthreads();
  double2* src = a;
  double2* dst = b;
  int log2ns = log2r;
  bits -= log2r;
  for (;;) {
    log2r = bits >= 3 ? 3 : bits;
    if (log2r == bits) {
      run_stage(log2r, Load{src, stride}, tw, log2h, log2ns, frames, last);
      return;
    }
    run_stage(log2r, Load{src, stride}, tw, log2h, log2ns, frames, Store{dst, stride});
    __syncthreads();
    double2* t = src;
    src = dst;
    dst = t;
    bits -= log2r;
    log2ns += log2r;
  }
}

// Forward h-point complex FFT (unscaled) of `frames` frames held in a, the
// frames `stride` points apart, with b (same layout) as the other buffer of
// the ping-pong; the last stage hands its outputs to last(f, i, value)
// (Store{a or b, stride} keeps them: b when stages(log2h) is odd, else a).
// Expects a barrier before the call; waits at one after each stage but the
// last.
template <class Last>
__device__ inline void fft(double2* a, double2* b, const double2* tw, int log2h, int frames,
                           int stride, const Last& last) {
  fft_from(Load{a, stride}, b, a, stride, tw, log2h, frames, last);
}

// --- Mixed radix (kernel D) ---------------------------------------------------

// The stages of an h-point FFT, h = 2^log2p 5^fives 3^threes: the
// power-of-two plan of stages(log2p), then the fives, then the threes.
// valid() is false where h has another prime factor.
struct Plan {
  int log2p, fives, threes, rest;  // rest: h without its factors 2, 3 and 5
  __host__ __device__ __forceinline__ bool valid() const { return rest == 1; }
  __host__ __device__ __forceinline__ bool mixed() const { return fives + threes > 0; }
  __host__ __device__ __forceinline__ int count() const { return stages(log2p) + fives + threes; }
  // the radix of stage s < count()
  __host__ __device__ __forceinline__ int radix(int s) const {
    const int s2 = stages(log2p);
    if (s < s2) {
      const int left = log2p - 3 * s;  // factors of two still to go
      return left >= 3 ? 8 : 1 << left;
    }
    return s - s2 < fives ? 5 : 3;
  }
};

__host__ __device__ inline Plan plan(int h) {
  Plan p{0, 0, 0, h};
  for (; p.rest > 1 && p.rest % 2 == 0; p.rest /= 2) ++p.log2p;
  for (; p.rest > 1 && p.rest % 5 == 0; p.rest /= 5) ++p.fives;
  for (; p.rest > 1 && p.rest % 3 == 0; p.rest /= 3) ++p.threes;
  return p;
}

// One Stockham stage of radix R over `frames` frames of h points read as
// in(f, i); ns is the product of the earlier stages' radices: stage()'s
// arithmetic with divisions for its shifts.  No barrier.
template <int R, class In, class Out>
__device__ __forceinline__ void mixed_stage(const In& in, const double2* tw, int h, int ns,
                                            int frames, const Out& out) {
  const int nb = h / R;            // butterflies per frame
  const int tstep = h / (ns * R);  // twiddle index k * h / (ns * R)
  for (int q = threadIdx.x; q < frames * nb; q += blockDim.x) {
    const int f = q / nb;
    const int j = q - f * nb;
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in(f, j + r * nb);
    const int k = j % ns;
    if (ns > 1) {
      double2 wr[R];
      powers<R>(twiddle(tw, k * tstep, h), wr);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = mul(v[r], wr[r]);
    }
    dft<R>(v);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out(f, base + r * ns, v[r]);
  }
}

template <class In, class Out>
__device__ __forceinline__ void run_mixed_stage(int radix, const In& in, const double2* tw,
                                                int h, int ns, int frames, const Out& out) {
  switch (radix) {
    case 8: mixed_stage<8>(in, tw, h, ns, frames, out); break;
    case 4: mixed_stage<4>(in, tw, h, ns, frames, out); break;
    case 2: mixed_stage<2>(in, tw, h, ns, frames, out); break;
    case 5: mixed_stage<5>(in, tw, h, ns, frames, out); break;
    default: mixed_stage<3>(in, tw, h, ns, frames, out); break;
  }
}

// fft() for h = 2^a 3^b 5^c points after plan(h) (p): the same contract,
// with p.count() stages in place of stages(log2h): a Store keeps the outputs
// in b when the count is odd, else in a.
template <class Last>
__device__ inline void fft_mixed(double2* a, double2* b, const double2* tw, int h, const Plan& p,
                                 int frames, int stride, const Last& last) {
  const int count = p.count();
  double2* src = a;
  double2* dst = b;
  int ns = 1;
  for (int s = 0; s + 1 < count; ++s) {
    const int radix = p.radix(s);
    run_mixed_stage(radix, Load{src, stride}, tw, h, ns, frames, Store{dst, stride});
    __syncthreads();
    double2* t = src;
    src = dst;
    dst = t;
    ns *= radix;
  }
  run_mixed_stage(p.radix(count - 1), Load{src, stride}, tw, h, ns, frames, last);
}

// Split post-pass for 0 <= k <= h/2: from zk = Z[k], zc = Z[(h - k) mod h]
// and w = exp(-2 pi i k / n), the unscaled onesided bins X[k] and X[h - k]
// (at k = 0: X[0] and X[h], both real).
__device__ __forceinline__ void split_forward(double2 zk, double2 zc, double2 w, double2& xk,
                                              double2& xc) {
  const double2 e = make_double2(0.5 * (zk.x + zc.x), 0.5 * (zk.y - zc.y));  // (zk + zc*) / 2
  const double2 d = make_double2(0.5 * (zk.x - zc.x), 0.5 * (zk.y + zc.y));  // (zk - zc*) / 2
  const double2 wo = mul(w, mul_neg_i(d));
  xk = add(e, wo);
  xc = make_double2(e.x - wo.x, wo.y - e.y);  // conj(e - wo)
}

// Split pre-pass for 0 <= k <= h/2: from the onesided bins yk = Y[k] and
// yc = Y[h - k] (real at k = 0) and w = exp(-2 pi i k / n), conj(Z'[k]) and
// conj(Z'[h - k]) of the packed spectrum (see the header).
__device__ __forceinline__ void split_inverse(double2 yk, double2 yc, double2 w, double2& zk,
                                              double2& zc) {
  const double2 e = make_double2(yk.x + yc.x, yk.y - yc.y);  // yk + yc*
  const double2 o = mul_conj(make_double2(yk.x - yc.x, yk.y + yc.y), w);  // (yk - yc*) w*
  zk = make_double2(e.x - o.y, -(e.y + o.x));  // conj(e + i o)
  zc = make_double2(e.x + o.y, e.y - o.x);     // conj(e* + i o*)
}

// --- A launch of frames (A, B, C) -------------------------------------------
//
// Each frame of n = 2h points gets h/8 threads, 8 points each per stage (one
// radix-8 butterfly, or two radix-4 or four radix-2 ones).  The pair pass
// gives thread l of a frame the pairs k = l + i h/8, i < kPairs.  Two plans:
//
// * one wave (frame_launch; B always, A and C on few frames): a block holds
//   one frame, or as many as make a whole warp below h = 256
//   (frames_per_block), and shared memory holds the twiddle table (h points),
//   then per frame two buffers of padded(h) points, the ping-pong of fft_from.
//   A frame is transformed at the latency of its stages, which is what a
//   launch of less than one wave costs.
// * many waves (frame_launch in place; A and C up to h = 1024): twice the
//   frames per block in the same shared memory, one twiddle table for them
//   all (copied with cp.async and swizzled) and one buffer per frame, each
//   stage of fft_frame reading its points into registers, waiting, then
//   overwriting them.  At n_fft 2048 a block of one frame takes 53,248 B, so
//   an SM holds four frames (16 warps); a block of two takes 53,248 B too,
//   and the kernel's bound of 80 registers a thread (at 64, for four blocks,
//   its stages spill) leaves an SM three: six frames, 24 warps.  Such a
//   launch is bound less by a frame's latency than by the SM's shared-memory
//   and L1 data path, which the stages' loads and stores, the twiddle loads
//   and the frame's global loads all cross: the swizzled table takes the
//   twiddle loads' bank conflicts off it, and an L2 prefetch of the state
//   and target rows at the start (fullrun.cuh) spreads the device-memory
//   reads over the forward stages.
//
// The wrapper chooses (ops/cuda/_fullrun.frame_plan, from the frames of the
// launch and n_fft alone): the one-wave plan while the frames fit in one wave
// of one-wave blocks (132 SMs times the blocks an SM's 228 KB of shared memory
// holds: 528 frames at n_fft 2048) or n_fft is 4096 (where a many-wave block
// of 512 threads leaves an SM one block, no more frames), else the many-wave
// one; the kernels check that the plan they are handed is one of the two.
// Each point of a frame goes through the same operations in either plan, so
// both give the same bits.

constexpr int kPairs = 5;          // ceil((h/2 + 1) / (h/8))
constexpr int kTwiddleLoads = 8;  // twiddle-table points per thread: at most h / (h/8)

__host__ __device__ __forceinline__ int frame_threads(int log2h) { return 1 << (log2h - 3); }

__host__ __device__ __forceinline__ int frames_per_block(int log2h) {
  return log2h >= 8 ? 1 : 32 >> (log2h - 3);
}

// A thread's points of the twiddle table (points threadIdx.x + e
// blockDim.x), loaded from device memory before the first stage, which
// reads none, and stored to shared memory after it.
struct TwiddleCopy {
  double2 v[kTwiddleLoads];
  __device__ __forceinline__ void load(const double2* __restrict__ tw, int h) {
#pragma unroll
    for (int e = 0; e < kTwiddleLoads; ++e) {
      const int i = threadIdx.x + e * blockDim.x;
      if (i < h) v[e] = __ldg(tw + i);
    }
  }
  __device__ __forceinline__ void store(double2* tw_s, int h) const {
#pragma unroll
    for (int e = 0; e < kTwiddleLoads; ++e) {
      const int i = threadIdx.x + e * blockDim.x;
      if (i < h) tw_s[i] = v[e];
    }
  }
};

// A launch of frames of h = 2^log2h points: frames per block, threads per
// block and dynamic shared memory in bytes.
struct FrameLaunch {
  int fpb;
  int threads;
  size_t smem;
};

// The launch of `kernel` over frames of h = 2^log2h points, on the one-wave
// plan (8 <= h <= 2048) or, in_place, on the many-wave plan (8 <= h <=
// 1024): twice the frames per block, one buffer each, so the same shared
// memory (cudaErrorInvalidValue outside those sizes); lets the kernel take
// shared memory above 48 KB.
template <class Kernel>
inline cudaError_t frame_launch(Kernel* kernel, int log2h, FrameLaunch* launch,
                                bool in_place = false) {
  if (log2h < 3 || log2h > (in_place ? 10 : 11)) return cudaErrorInvalidValue;
  const int h = 1 << log2h;
  const int buffers = in_place ? 1 : 2;
  launch->fpb = (in_place ? 2 : 1) * frames_per_block(log2h);
  launch->threads = launch->fpb * frame_threads(log2h);
  launch->smem = sizeof(double2) * (h + buffers * static_cast<size_t>(launch->fpb) * padded(h));
  if (launch->smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(launch->smem));
  }
  return cudaSuccess;
}

// --- One frame in place (the many-wave plan) --------------------------------
//
// Thread l < h/8 of frame f works on that frame alone, in its one buffer z:
// stage by stage it reads its 8 points (butterflies j = l + m h/8), twiddles
// them and runs their DFTs in registers, waits until every thread of the
// frame has read (wait()), then stores them where the Stockham order puts
// them.  A butterfly's operations are those of stage(), so the outputs are
// the same bits.  Threads of a frame past the launch's last (live false)
// take every wait and touch no memory.

// The threads of a frame wait for each other: the block, whose two frames
// then go in step (named barriers, one a frame, measured no faster), or the
// warp where a warp holds several frames (h < 256).
struct FrameSync {
  int threads;  // of a frame
  __device__ __forceinline__ void operator()() const {
    if (threads < 32) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
};

// A frame's buffer: point i read, or stored, at its skewed position.
struct FrameLoad {
  const double2* z;
  __device__ __forceinline__ double2 operator()(int, int i) const { return z[at(i)]; }
};

struct FrameStore {
  double2* z;
  __device__ __forceinline__ void operator()(int, int i, double2 v) const { z[at(i)] = v; }
};

// Where the copied table keeps tw[i]: the low three bits of i XORed with the
// next two groups of three, a permutation within each aligned group of
// eight.  A stage reads tw[s k] over 8 consecutive k in a quarter-warp, for
// a stride s from 1 to 64; unswizzled, strides of 2 and more put those 16-byte
// reads on a quarter to a half of the banks (2- to 8-way conflicts), and
// swizzled on all of them.
__host__ __device__ __forceinline__ int swizzled(int i) {
  return i ^ (((i >> 3) ^ (i >> 6)) & 7);
}

// exp(-2 pi i m / h), m < h, from the swizzled copy of the n/2-entry table.
__device__ __forceinline__ double2 twiddle_swizzled(const double2* tw_s, int m, int h) {
  const int j = 2 * m;
  if (j < h) return tw_s[swizzled(j)];
  const double2 t = tw_s[swizzled(j - h)];
  return make_double2(-t.x, -t.y);
}

// The twiddle table (h points) copied from device memory to shared memory,
// swizzled, by the block's threads with cp.async, which holds no registers
// while the first stage runs; wait_copies() before anyone reads it.
__device__ __forceinline__ void copy_twiddles(double2* tw_s, const double2* __restrict__ tw,
                                              int h) {
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(tw_s + swizzled(i)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(tw + i) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One Stockham stage of radix R of frame f (thread l) as described above:
// points from in(f, i), wait(), outputs to out(f, i, value).
template <int R, class In, class Out, class Wait>
__device__ __forceinline__ void frame_stage(const In& in, const double2* tw_s, int log2h,
                                            int log2ns, int f, int l, bool live, const Out& out,
                                            const Wait& wait) {
  constexpr int log2r = R == 8 ? 3 : (R == 4 ? 2 : 1);
  constexpr int M = 8 / R;  // butterflies per thread: h/R over h/8 threads
  const int log2nb = log2h - log2r;
  const int ns = 1 << log2ns;
  const int tstep = log2h - log2ns - log2r;
  const int tpf = frame_threads(log2h);
  double2 v[M][R];
  if (live) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = l + m * tpf;
#pragma unroll
      for (int r = 0; r < R; ++r) v[m][r] = in(f, j + (r << log2nb));
      const int k = j & (ns - 1);
      if (ns > 1) {
        double2 wr[R];
        powers<R>(twiddle_swizzled(tw_s, k << tstep, 1 << log2h), wr);
#pragma unroll
        for (int r = 1; r < R; ++r) v[m][r] = mul(v[m][r], wr[r]);
      }
      dft<R>(v[m]);
    }
  }
  wait();
  if (live) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = l + m * tpf;
      const int k = j & (ns - 1);
      const int base = ((j - k) << log2r) + k;
#pragma unroll
      for (int r = 0; r < R; ++r) out(f, base + (r << log2ns), v[m][r]);
    }
  }
}

template <class In, class Out, class Wait>
__device__ __forceinline__ void run_frame_stage(int log2r, const In& in, const double2* tw_s,
                                                int log2h, int log2ns, int f, int l, bool live,
                                                const Out& out, const Wait& wait) {
  if (log2r == 3) {
    frame_stage<8>(in, tw_s, log2h, log2ns, f, l, live, out, wait);
  } else if (log2r == 2) {
    frame_stage<4>(in, tw_s, log2h, log2ns, f, l, live, out, wait);
  } else {
    frame_stage<2>(in, tw_s, log2h, log2ns, f, l, live, out, wait);
  }
}

// Forward h-point complex FFT (unscaled) of frame f in its buffer z, the
// twiddles from tw_s (the swizzled table of copy_twiddles), in the stages of
// fft_from: the first stage reads first(f, i) (z itself if FROM_Z) and
// stores to z, every later stage reads z and stores to z, and the last one
// hands its outputs to last(f, i, value) (into z if TO_Z).  A stage that
// reads and stores z waits between the two.  after_first() runs right after
// the first stage, by every thread, and orders its stores before the next
// stage's loads (the forward waits there for the twiddle table's copy and
// the whole block); after each later stage but the last the frame waits;
// the caller waits after the last.  The first stage reads no twiddle.
template <bool FROM_Z, bool TO_Z, class First, class Last, class Wait, class Hook>
__device__ inline void fft_frame(const First& first, double2* z, const double2* tw_s, int log2h,
                                 int f, int l, bool live, const Last& last, const Wait& wait,
                                 const Hook& after_first) {
  const FrameLoad read{z};
  const FrameStore keep{z};
  int bits = log2h, log2r = bits >= 3 ? 3 : bits;
  if (log2r == bits) {
    if constexpr (FROM_Z && TO_Z) {
      run_frame_stage(log2r, first, tw_s, log2h, 0, f, l, live, last, wait);
    } else {
      run_frame_stage(log2r, first, tw_s, log2h, 0, f, l, live, last, NoHook{});
    }
    after_first();
    return;
  }
  if constexpr (FROM_Z) {
    run_frame_stage(log2r, first, tw_s, log2h, 0, f, l, live, keep, wait);
  } else {
    run_frame_stage(log2r, first, tw_s, log2h, 0, f, l, live, keep, NoHook{});
  }
  after_first();
  int log2ns = log2r;
  bits -= log2r;
  for (;;) {
    log2r = bits >= 3 ? 3 : bits;
    if (log2r == bits) {
      if constexpr (TO_Z) {
        run_frame_stage(log2r, read, tw_s, log2h, log2ns, f, l, live, last, wait);
      } else {
        run_frame_stage(log2r, read, tw_s, log2h, log2ns, f, l, live, last, NoHook{});
      }
      return;
    }
    run_frame_stage(log2r, read, tw_s, log2h, log2ns, f, l, live, keep, wait);
    wait();
    bits -= log2r;
    log2ns += log2r;
  }
}

}  // namespace rfft
}  // namespace specinv
