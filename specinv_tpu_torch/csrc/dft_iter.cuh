// The direct-DFT iteration engine shared by gl_fused.cu and admm_fused.cu:
// one iteration is the forward DFT with the algorithm's middle in its
// epilogue, the inverse DFT, and fullrun.cuh's ola_kernel.
//
// The DFT is a pair of matrix products against cos/sin tables (ops/dft.py,
// the counterpart of gl_fused._dft_tables): for each clip b,
//
//   S      = frames @ C  -  i * frames @ Sn       frames (T, n), C/Sn (n, F)
//   frames = window * (P_re @ C^T - P_im @ Sn^T)  P (T, F), Hermitian fold
//                                                 weights w folded into P
//
// with frames[t, k] = x_pad[b, t*hop + k] * window[k].  Each product runs in
// one of the precision schemes of gl_fused.py:101-164:
//
//   kDefault   ah*bh                        one bf16 tensor-core pass
//   kHigh      ah*bh + ah*bl + al*bh        three passes (JAX HIGH)
//   kBf16x2    ah*bh + ah*bl                two passes, table low bits
//   kBf16x2t   ah*bh + al*bh                two passes, data low bits
//   kHighest   float32 on the CUDA cores
//
// with hi = bf16_rn(x), lo = bf16_rn(x - hi) (JAX's astype rounding).
//
// The bf16 schemes: one product with complex parts interleaved.  Both
// products are one real matrix product against M2 (n, 2F), M2[k, 2f] =
// C[k, f] and M2[k, 2f + 1] = -Sn[k, f] (negation is exact):
//
//   S interleaved (T, 2F)  = frames @ M2          K = n
//   frames                 = P interleaved @ M2^T K = 2F
//
// so one output tile of the forward holds both parts of its bins, and the
// inverse is one product of depth 2F instead of two of depth F.  The wrapper
// caches M2 in the layouts the tensor cores read (ops/cuda/_dft.py
// interleaved_tables): the forward's B operand is M2^T (2F_pad, n_pad), the
// inverse's M2 (n_pad, 2F_pad), both split into bf16 hi/lo planes, with F_pad
// = F rounded up to 32 and n_pad = n rounded up to 64 and zeros in the pad,
// so every row is a whole number of 128-byte lines.  The data operands are
// split once per iteration, not once per tile: frame_split_kernel writes the
// framed, windowed signal as bf16 hi/lo planes (B, T, n_pad) (a tensor-map
// copy cannot frame an arbitrary hop: t*hop*4 bytes is 16-byte aligned only
// when 4 | hop), and the forward's epilogue writes P as hi/lo planes (B, T,
// 2F_pad) with its own zero padding.  The splits are the ones split_bf16
// makes of the float32 values, so the schemes compute the same function.
//
// split_gemm_kernel computes a 64-row x 128-column output tile of one clip:
// a producer warp keeps a ring of kStages shared-memory stages filled by the
// Tensor Memory Accelerator (one 64 x 64 tile of each data half and one 128
// x 64 tile of each table half per stage, 128-byte swizzled, out-of-bounds
// rows zero-filled, completion on an mbarrier per stage), and two consumer
// warpgroups, each owning 64 of the 128 columns, issue wgmma.mma_async
// m64n64k16 (bf16 in, float32 accumulate) from the stage's tiles, every pass
// of the scheme on the same stage into one accumulator started from zero.
// Once a stage's products are done, a warpgroup adds them into float32 sums
// in registers, rounded to nearest, and releases the stage (one arrival per
// consumer warp on its empty barrier); the two warpgroups of an SM take
// turns on the tensor cores.  Summing per 64-deep stage keeps the result as
// close to float64 as the plain version's: the tensor cores' own float32
// accumulation over the whole contraction of 2048 lay about 24x farther
// (scripts/torch_dft_variants.py).  The epilogue gets the sums through shared memory as
// pairs of neighbouring columns, a warp on 32 consecutive pairs of one row:
// in the forward the (re, im) of 32 bins.
//
// kHighest keeps the float32 products on the CUDA cores (64 x 64 tiles, 8
// warps, 4 x 4 outputs a thread, tables read as float32 (n, F)): TF32 would
// not compute its function.  Its forward writes P in whatever form the
// inverse's scheme reads.
//
// A Middle is a functor with
//   __device__ float2 operator()(float2 s, float2& state, float tgt, float w,
//                                bool valid) const;
// where s is the forward bin (re, im), state the bin's state (read from
// state_in, then written to state_out, which may be the same buffer), tgt
// the target magnitude, w the bin's fold weight and valid whether the frame
// lies below valid_t; it returns the bin of P.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fullrun.cuh"

namespace specinv {
namespace {

// The order of ops/dft.py SCHEMES.
enum Scheme { kDefault = 0, kHigh = 1, kHighest = 2, kBf16x2 = 3, kBf16x2t = 4 };

template <int S>
struct SchemeTraits {
  static constexpr bool kBLo = S == kHigh || S == kBf16x2;   // the ah*bl pass
  static constexpr bool kALo = S == kHigh || S == kBf16x2t;  // the al*bh pass
};

inline bool data_lo(int s) { return s == kHigh || s == kBf16x2t; }

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// Hopper primitives: shared-memory addresses, mbarriers, TMA, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The wgmma descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzled (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups
// 1024 bytes apart; the start address steps 32 bytes per k16 slice.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// this point (the tensor cores write it asynchronously).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, desc a) * B (16 x 64, desc b) + (accumulate ? d : 0),
// bf16 in, float32 out.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// The split products on the tensor cores.

constexpr int kTileM = 64;                          // rows (frames) per tile
constexpr int kTileN = 128;                         // columns per tile
constexpr int kTileK = 64;                          // depth per stage: one 128-byte row
constexpr int kConsumers = kTileN / 64;             // warpgroups, 64 columns each
constexpr int kGemmThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kStages = 4;
constexpr int kATile = kTileM * kTileK * 2;  // bytes of one data half's tile
constexpr int kBTile = kTileN * kTileK * 2;  // bytes of one table half's tile
constexpr int kStageBytes = 2 * kATile + 2 * kBTile;
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + alignment of the ring
constexpr int kLdTile = kTileN + 4;  // float32 result tile of the epilogue, in the ring
static_assert(kGemmSmem <= 227 * 1024, "the ring must fit in shared memory");
static_assert(kTileM * kLdTile * 4 <= kStages * kStageBytes, "the result tile fits the ring");

// Waits for a stage and issues its products into acc, every pass of the
// scheme, acc started from zero: a 64 x 64 data tile (hi at stage, lo after
// it) against the warpgroup's 64 x 64 part of the table tiles (at stage +
// b_off, lo kBTile after it), 4 k16 steps.
template <int S>
__device__ __forceinline__ void issue_stage(float (&acc)[32], uint32_t stage, uint32_t b_off,
                                            uint32_t full_bar, uint32_t parity) {
  mbar_wait(full_bar, parity);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t ah = sw128_desc(stage + kk * 32), bh = sw128_desc(stage + b_off + kk * 32);
    wgmma_m64n64k16(acc, ah, bh, kk > 0);
    if constexpr (SchemeTraits<S>::kBLo) {
      wgmma_m64n64k16(acc, ah, sw128_desc(stage + b_off + kBTile + kk * 32), 1);
    }
    if constexpr (SchemeTraits<S>::kALo) {
      wgmma_m64n64k16(acc, sw128_desc(stage + kATile + kk * 32), bh, 1);
    }
  }
  wgmma_commit();
}

// C (rows of clip blockIdx.z, columns) = A (B, rows, K) @ B^T (columns, K),
// both operands K-major bf16 halves behind tensor maps, in the scheme S;
// the epilogue gets each thread's pairs of neighbouring columns.  rows
// masks the tile's last row; k_tiles = K / kTileK.
template <int S, class Epilogue>
__global__ void __launch_bounds__(kGemmThreads, 1) split_gemm_kernel(
    const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
    const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
    int rows, int k_tiles, const Epilogue epi) {
  constexpr bool kALo = SchemeTraits<S>::kALo, kBLo = SchemeTraits<S>::kBLo;
  extern __shared__ unsigned char gemm_smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer
    if (lane == 0) {
      constexpr uint32_t kBytes = kATile * (kALo ? 2 : 1) + kBTile * (kBLo ? 2 : 1);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(smem_u32(&empty[s]), ((kt / kStages) - 1) & 1);
        const uint32_t stage = ring + s * kStageBytes, bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, kBytes);
        tma_load_3d(stage, &a_hi, bar, kt * kTileK, m0, b);
        if constexpr (kALo) tma_load_3d(stage + kATile, &a_lo, bar, kt * kTileK, m0, b);
        tma_load_2d(stage + 2 * kATile, &b_hi, bar, kt * kTileK, n0);
        if constexpr (kBLo) tma_load_2d(stage + 2 * kATile + kBTile, &b_lo, bar, kt * kTileK, n0);
      }
    }
    return;
  }

  // A consumer warpgroup: all 64 rows, columns [64 wg, 64 wg + 64) of the
  // tile.  Each stage's products start from zero and are added into the
  // float32 sums once they are done; then the stage is released.  While one
  // warpgroup waits and adds, the other's products run.
  const int wg = warp / 4;
  const uint32_t b_off = 2 * kATile + wg * (kBTile / kConsumers);
  float sum[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    issue_stage<S>(acc, ring + s * kStageBytes, b_off, smem_u32(&full[s]), (kt / kStages) & 1);
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

  // The sums go through shared memory (the ring is spent once both
  // warpgroups are done with it), so that the epilogue walks the tile with
  // neighbouring threads on neighbouring column pairs: a warp reads and
  // writes 32 consecutive pairs of one row.  Register i of a thread holds
  // row 16 w + lane/4 + 8 ((i/2) % 2) and column 8 (i/4) + 2 (lane % 4) +
  // i % 2 of the warpgroup's 64 x 64 block.
  float* tile = reinterpret_cast<float*>(gemm_smem + (ring - smem_u32(gemm_smem)));
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  const int w = warp % 4;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = w * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int c = wg * 64 + 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(tile + r * kLdTile + c) = make_float2(sum[i], sum[i + 1]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  // thread t: pair t % 64 of rows t / 64 + 4 q, q < 16; every operand
  // loaded first, one round trip to memory
  constexpr int kRowStep = 128 * kConsumers / (kTileN / 2);
  const int tid = threadIdx.x, cp = tid % (kTileN / 2), c = n0 + 2 * cp;
  typename Epilogue::Operands ops[kTileM / kRowStep];
#pragma unroll
  for (int q = 0; q < kTileM / kRowStep; ++q) {
    const int r = m0 + tid / (kTileN / 2) + kRowStep * q;
    if (r < rows) ops[q] = epi.load(b, r, c);
  }
#pragma unroll
  for (int q = 0; q < kTileM / kRowStep; ++q) {
    const int rl = tid / (kTileN / 2) + kRowStep * q;
    const float2 v = *reinterpret_cast<const float2*>(tile + rl * kLdTile + 2 * cp);
    if (m0 + rl < rows) epi.store(b, m0 + rl, c, v.x, v.y, ops[q]);
  }
}

// The framed, windowed signal split into bf16 planes (B, T, n_pad), zeros
// at k >= n; lo may be null.  A thread makes 8 neighbouring values of one
// frame (one 16-byte store per plane).
__global__ void frame_split_kernel(const float* __restrict__ x_pad,
                                   const float* __restrict__ window, bf16* __restrict__ hi,
                                   bf16* __restrict__ lo, int B, int T, int n, int n_pad,
                                   int hop, int lp) {
  const int groups = n_pad / 8;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * T * groups) return;
  const size_t row = i / groups;
  const int k0 = static_cast<int>(i % groups) * 8;
  const int b = static_cast<int>(row / T), t = static_cast<int>(row % T);
  const float* xf = x_pad + static_cast<size_t>(b) * lp + static_cast<size_t>(t) * hop;
  __align__(16) bf16 h[8], l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + j;
    const float v = k < n ? __fmul_rn(xf[k], window[k]) : 0.0f;
    h[j] = __float2bfloat16_rn(v);
    l[j] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h[j])));
  }
  const size_t o = row * n_pad + k0;
  *reinterpret_cast<uint4*>(hi + o) = *reinterpret_cast<const uint4*>(h);
  if (lo != nullptr) *reinterpret_cast<uint4*>(lo + o) = *reinterpret_cast<const uint4*>(l);
}

// Where the forward writes P: spec (B, T, F) complex for a float32 inverse,
// or the interleaved bf16 planes (B, T, 2 F_pad) (lo may be null).
struct POut {
  float2* spec;
  bf16* hi;
  bf16* lo;
};

// An epilogue gets the result in pairs of neighbouring columns (c even):
// load(b, t, c) returns what the pair's store needs from memory, and
// store(b, t, c, v0, v1, ops) writes the pair.
//
// The forward's: for bin f = c / 2 of frame t, mag = |S| (if requested),
// the Middle (state updated), P stored.  Columns of the pad (F <= f <
// F_pad) get zeros in the planes, which the inverse reads.
template <class Middle>
struct ForwardEpilogue {
  const float2* state_in;  // (B, T, F)
  float2* state_out;       // (B, T, F), may be state_in
  const float* target;     // (B, T, F)
  const float* wts;        // (F) fold weights * iscale / fscale
  float* mag;              // (B, T, F) or null
  POut p;
  int T, n_bins, f_pad, valid_t;
  Middle middle;

  struct Operands {
    float2 state;
    float tgt, w;
  };

  __device__ __forceinline__ Operands load(int b, int t, int c) const {
    const int f = c / 2;
    if (f >= n_bins) return Operands{};
    const size_t idx = (static_cast<size_t>(b) * T + t) * n_bins + f;
    return Operands{state_in[idx], target[idx], wts[f]};
  }

  __device__ __forceinline__ void store(int b, int t, int c, float re, float im,
                                        const Operands& in) const {
    const int f = c / 2;
    if (f >= f_pad) return;
    const size_t row = static_cast<size_t>(b) * T + t;
    if (f >= n_bins) {
      zero_p(row, c);
      return;
    }
    const size_t idx = row * n_bins + f;
    float2 st = in.state;
    const float2 out = bin(make_float2(re, im), st, idx, in.tgt, in.w, t);
    state_out[idx] = st;
    put_p(row, c, idx, out);
  }

  // mag (if requested) and the Middle on bin s at idx of frame t.  Rounded
  // products and sums (never contracted into an FMA), so the state does not
  // depend on whether mag is written.
  __device__ __forceinline__ float2 bin(float2 s, float2& st, size_t idx, float tgt, float w,
                                        int t) const {
    if (mag != nullptr) {
      mag[idx] = __fsqrt_rn(__fadd_rn(__fmul_rn(s.x, s.x), __fmul_rn(s.y, s.y)));
    }
    return middle(s, st, tgt, w, t < valid_t);
  }

  // P's bin at idx, column pair c of P's row, in the form the inverse reads.
  __device__ __forceinline__ void put_p(size_t row, int c, size_t idx, float2 out) const {
    if (p.spec != nullptr) p.spec[idx] = out;
    if (p.hi != nullptr) {
      const bf16 hr = __float2bfloat16_rn(out.x), hi_ = __float2bfloat16_rn(out.y);
      *reinterpret_cast<__nv_bfloat162*>(p.hi + row * 2 * f_pad + c) = __halves2bfloat162(hr, hi_);
      if (p.lo != nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(p.lo + row * 2 * f_pad + c) = __halves2bfloat162(
            __float2bfloat16_rn(__fsub_rn(out.x, __bfloat162float(hr))),
            __float2bfloat16_rn(__fsub_rn(out.y, __bfloat162float(hi_))));
      }
    }
  }

  // zeros at the pad's column pair c of P's planes
  __device__ __forceinline__ void zero_p(size_t row, int c) const {
    if (p.hi != nullptr) {
      const __nv_bfloat162 z = __floats2bfloat162_rn(0.0f, 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(p.hi + row * 2 * f_pad + c) = z;
      if (p.lo != nullptr) *reinterpret_cast<__nv_bfloat162*>(p.lo + row * 2 * f_pad + c) = z;
    }
  }
};

// The inverse's: samples j, j + 1 of frame t, times the window, into the
// (B, T, n) frame scratch that ola_kernel reads.
struct InverseEpilogue {
  const float* window;
  float* frames;
  int T, n;

  using Operands = float2;  // the window at j, j + 1

  __device__ __forceinline__ Operands load(int, int, int j) const {
    return make_float2(j < n ? window[j] : 0.0f, j + 1 < n ? window[j + 1] : 0.0f);
  }

  __device__ __forceinline__ void store(int b, int t, int j, float v0, float v1,
                                        const Operands& w) const {
    float* out = frames + (static_cast<size_t>(b) * T + t) * n;
    if (j < n) out[j] = __fmul_rn(v0, w.x);
    if (j + 1 < n) out[j + 1] = __fmul_rn(v1, w.y);
  }
};

// ---------------------------------------------------------------------------
// HIGHEST: the float32 products on the CUDA cores, 64 x 64 output tiles.

constexpr int kBM = 64;          // rows (frames) per tile
constexpr int kBN = 64;          // columns (bins or samples) per tile
constexpr int kBK = 32;          // contraction per shared-memory tile
constexpr int kThreads = 256;    // 8 warps
constexpr int kLdO = kBN + 4;    // float32 result tile
constexpr int kLdP = kBM + 1;    // float32 transposed tiles

constexpr int kFwdSmem = 2 * kBM * kLdO * 4;  // the two result tiles, the largest use
constexpr int kInvSmem = 4 * kBK * kLdP * 4;

// Forward product of one tile: stage_re / stage_im (kBM x kLdO) get frames
// @ C and frames @ Sn; each thread owns 4 rows x 4 columns of both.  Not
// inlined: compiled inside the kernel, the loop's registers and schedule
// followed the Middle's epilogue, and on an H100 the ADMM instance ran
// slower than the GL one, and both slower than this loop on its own.
__device__ __noinline__ void forward_f32(unsigned char* smem, const float* __restrict__ xb,
                            const float* __restrict__ window, const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t, int t0, int f0, int T, int n,
                            int hop, int n_bins, float* stage_re, float* stage_im) {
  float* a = reinterpret_cast<float*>(smem);  // [kBK][kLdP], transposed
  float* c = a + kBK * kLdP;                  // [kBK][kBN]
  float* s = c + kBK * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc_re[4][4] = {}, acc_im[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK, t = t0 + r, kk = k0 + k;
      a[k * kLdP + r] = (t < T && kk < n)
                            ? __fmul_rn(xb[static_cast<size_t>(t) * hop + kk], window[kk])
                            : 0.0f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, col = i % kBN, kk = k0 + k, f = f0 + col;
      const bool in = kk < n && f < n_bins;
      const size_t g = static_cast<size_t>(kk) * n_bins + f;
      c[i] = in ? cos_t[g] : 0.0f;
      s[i] = in ? sin_t[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float av[4], cv[4], sv[4];
      for (int i = 0; i < 4; ++i) av[i] = a[k * kLdP + ty * 4 + i];
      for (int j = 0; j < 4; ++j) {
        cv[j] = c[k * kBN + tx * 4 + j];
        sv[j] = s[k * kBN + tx * 4 + j];
      }
      for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = fmaf(av[i], cv[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(av[i], sv[j], acc_im[i][j]);
        }
      }
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      stage_re[(ty * 4 + i) * kLdO + tx * 4 + j] = acc_re[i][j];
      stage_im[(ty * 4 + i) * kLdO + tx * 4 + j] = acc_im[i][j];
    }
  }
}

// Forward DFT of a 64-frame x 64-bin tile of clip blockIdx.z in float32,
// then the forward epilogue on each bin (bins up to F_pad, for the planes'
// zero padding).
template <class Middle>
__global__ void __launch_bounds__(kThreads) dft_forward_f32_kernel(
    const float* __restrict__ x_pad,  // (B, lp)
    const float* __restrict__ window, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int n, int hop, int lp, const ForwardEpilogue<Middle> epi) {
  __shared__ __align__(128) unsigned char smem[kFwdSmem];
  float* stage_re = reinterpret_cast<float*>(smem);
  float* stage_im = stage_re + kBM * kLdO;
  const int f0 = blockIdx.x * kBN, t0 = blockIdx.y * kBM, b = blockIdx.z;
  const int T = epi.T, n_bins = epi.n_bins, f_pad = epi.f_pad;
  forward_f32(smem, x_pad + static_cast<size_t>(b) * lp, window, cos_t, sin_t, t0, f0, T, n, hop,
              n_bins, stage_re, stage_im);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN, t = t0 + r, f = f0 + c;
    if (t >= T || f >= f_pad) continue;
    const size_t row = static_cast<size_t>(b) * T + t;
    if (f >= n_bins) {
      epi.zero_p(row, 2 * f);
      continue;
    }
    const size_t idx = row * n_bins + f;
    float2 st = epi.state_in[idx];
    const float2 out = epi.bin(make_float2(stage_re[r * kLdO + c], -stage_im[r * kLdO + c]), st,
                               idx, epi.target[idx], epi.wts[f], t);
    epi.state_out[idx] = st;
    epi.put_p(row, 2 * f, idx, out);
  }
}

// The inverse product of one tile in float32: stage (kBM x kLdO) gets P_re
// @ C^T - P_im @ Sn^T.
__device__ void inverse_f32(unsigned char* smem, const float2* __restrict__ pb,
                            const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                            int t0, int j0, int T, int n, int n_bins, float* stage) {
  float* are = reinterpret_cast<float*>(smem);  // [kBK][kLdP], transposed
  float* aim = are + kBK * kLdP;
  float* c = aim + kBK * kLdP;                   // [kBK][kLdP]: (k, j) at k*kLdP + j
  float* s = c + kBK * kLdP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc_re[4][4] = {}, acc_im[4][4] = {};
  for (int k0 = 0; k0 < n_bins; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK, t = t0 + r, kk = k0 + k;
      const float2 v = (t < T && kk < n_bins) ? pb[static_cast<size_t>(t) * n_bins + kk]
                                              : make_float2(0.0f, 0.0f);
      are[k * kLdP + r] = v.x;
      aim[k * kLdP + r] = v.y;
    }
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int j = i / kBK, k = i % kBK, jj = j0 + j, kk = k0 + k;
      const bool in = jj < n && kk < n_bins;
      const size_t g = static_cast<size_t>(jj) * n_bins + kk;
      c[k * kLdP + j] = in ? cos_t[g] : 0.0f;
      s[k * kLdP + j] = in ? sin_t[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float rv[4], iv[4], cv[4], sv[4];
      for (int i = 0; i < 4; ++i) {
        rv[i] = are[k * kLdP + ty * 4 + i];
        iv[i] = aim[k * kLdP + ty * 4 + i];
      }
      for (int j = 0; j < 4; ++j) {
        cv[j] = c[k * kLdP + tx * 4 + j];
        sv[j] = s[k * kLdP + tx * 4 + j];
      }
      for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = fmaf(rv[i], cv[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(iv[i], sv[j], acc_im[i][j]);
        }
      }
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      stage[(ty * 4 + i) * kLdO + tx * 4 + j] = __fsub_rn(acc_re[i][j], acc_im[i][j]);
    }
  }
}

// Inverse DFT of a 64-frame x 64-sample tile of clip blockIdx.z in
// float32, times the window, into the frame scratch.
__global__ void __launch_bounds__(kThreads) dft_inverse_f32_kernel(
    const float2* __restrict__ spec,  // (B, T, F) P
    const float* __restrict__ cos_t, const float* __restrict__ sin_t, int n_bins,
    const InverseEpilogue epi) {
  __shared__ __align__(128) unsigned char smem[kInvSmem];
  float* stage = reinterpret_cast<float*>(smem);
  const int j0 = blockIdx.x * kBN, t0 = blockIdx.y * kBM, b = blockIdx.z;
  inverse_f32(smem, spec + static_cast<size_t>(b) * epi.T * n_bins, cos_t, sin_t, t0, j0, epi.T,
              epi.n, n_bins, stage);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN, t = t0 + r, j = j0 + c;
    if (t < epi.T && j < epi.n) {
      epi.frames[(static_cast<size_t>(b) * epi.T + t) * epi.n + j] =
          __fmul_rn(stage[r * kLdO + c], epi.window[j]);
    }
  }
}

static_assert(kBK * kLdP * 4 + 2 * kBK * kBN * 4 <= kFwdSmem, "forward_f32 tiles");
static_assert(kBM * kLdO * 4 <= kInvSmem, "inverse result tile");

// ---------------------------------------------------------------------------
// Host side.

// Calls f(std::integral_constant<int, S>) for the scheme code s; false if
// s is no scheme.
template <class F>
bool with_scheme(int s, F&& f) {
  switch (s) {
    case kDefault: f(std::integral_constant<int, kDefault>{}); return true;
    case kHigh: f(std::integral_constant<int, kHigh>{}); return true;
    case kHighest: f(std::integral_constant<int, kHighest>{}); return true;
    case kBf16x2: f(std::integral_constant<int, kBf16x2>{}); return true;
    case kBf16x2t: f(std::integral_constant<int, kBf16x2t>{}); return true;
    default: return false;
  }
}

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (the library links no libcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tensor map of a bf16 array (planes, rows, cols), of rank 3, or of rank
// 2 for a matrix (planes 1), read in boxes of kTileK columns x box_rows
// rows, 128-byte swizzled; rows past the end read as zeros.
inline bool make_map(CUtensorMap* map, int rank, const bf16* base, int planes, int rows,
                     int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || base == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {kTileK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                const_cast<bf16*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One split product: out[b] (rows, cols) = a[b] (rows, K) @ tab^T (cols, K)
// with a (B, rows, K) and tab (tab_rows, K) bf16 halves (lo may be null
// where the scheme reads none).  K is a multiple of kTileK.
template <int S, class Epilogue>
cudaError_t launch_split_gemm(const bf16* a_hi, const bf16* a_lo, const bf16* t_hi,
                              const bf16* t_lo, int B, int rows, int K, int tab_rows, int cols,
                              const Epilogue& epi, cudaStream_t stream) {
  CUtensorMap m_ahi, m_alo, m_bhi, m_blo;
  const bool ok =
      make_map(&m_ahi, 3, a_hi, B, rows, K, kTileM) &&
      make_map(&m_alo, 3, SchemeTraits<S>::kALo ? a_lo : a_hi, B, rows, K, kTileM) &&
      make_map(&m_bhi, 2, t_hi, 1, tab_rows, K, kTileN) &&
      make_map(&m_blo, 2, SchemeTraits<S>::kBLo ? t_lo : t_hi, 1, tab_rows, K, kTileN);
  if (!ok) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_gemm_kernel<S, Epilogue>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(cdiv(cols, kTileN), cdiv(rows, kTileM), B);
  split_gemm_kernel<S, Epilogue><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      m_ahi, m_alo, m_bhi, m_blo, rows, K / kTileK, epi);
  return cudaGetLastError();
}

// The device buffers of one iteration.  The float32 tables (n, F) serve
// kHighest; fwd (2 F_pad, n_pad) and inv (n_pad, 2 F_pad) are M2^T and M2
// as bf16 halves (lo may be null where no scheme of the call reads it).
// frame_hi/lo (B, T, n_pad) are the forward's split frames (null for a
// kHighest forward); p (spec or the planes) is what the inverse reads.
struct Buffers {
  const float* cos;
  const float* sin;
  const bf16* fwd_hi;
  const bf16* fwd_lo;
  const bf16* inv_hi;
  const bf16* inv_lo;
  bf16* frame_hi;
  bf16* frame_lo;
  POut p;
  float* frames;  // (B, T, n) float32 scratch
};

// One iteration: x_in -> x_out (distinct buffers), state_in -> state_out
// (may be one buffer), mag may be null.  Returns the first launch error (0
// if none).
template <class Middle>
int run_dft_iteration(const float* x_in, float* x_out, const float2* state_in,
                      float2* state_out, const float* target, const float* window,
                      const float* wts, const Buffers& buf, const float* inv_env, float* mag,
                      int B, int T, int n, int hop, int n_bins, int lp, int p_amt, int e,
                      int pad_mode, int fwd_scheme, int inv_scheme, int valid_t, Middle middle,
                      cudaStream_t stream) {
  const int n_pad = static_cast<int>(cdiv(n, 64)) * 64;
  const int f_pad = static_cast<int>(cdiv(n_bins, 32)) * 32;
  if (inv_scheme == kHighest ? buf.p.spec == nullptr
                             : buf.p.hi == nullptr || (data_lo(inv_scheme) && buf.p.lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ForwardEpilogue<Middle> fwd_epi{state_in, state_out, target, wts, mag, buf.p,
                                        T, n_bins, f_pad, valid_t, middle};
  cudaError_t err = cudaSuccess;
  const bool fwd_ok = with_scheme(fwd_scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    if constexpr (S == kHighest) {
      const dim3 grid(cdiv(f_pad, kBN), cdiv(T, kBM), B);
      dft_forward_f32_kernel<Middle><<<grid, kThreads, 0, stream>>>(
          x_in, window, buf.cos, buf.sin, n, hop, lp, fwd_epi);
      err = cudaGetLastError();
    } else {
      const size_t groups = static_cast<size_t>(B) * T * (n_pad / 8);
      frame_split_kernel<<<static_cast<unsigned>((groups + 255) / 256), 256, 0, stream>>>(
          x_in, window, buf.frame_hi, SchemeTraits<S>::kALo ? buf.frame_lo : nullptr, B, T, n,
          n_pad, hop, lp);
      err = cudaGetLastError();
      if (err == cudaSuccess) {
        err = launch_split_gemm<S>(buf.frame_hi, buf.frame_lo, buf.fwd_hi, buf.fwd_lo, B, T,
                                   n_pad, 2 * f_pad, 2 * f_pad, fwd_epi, stream);
      }
    }
  });
  if (!fwd_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  const InverseEpilogue inv_epi{window, buf.frames, T, n};
  const bool inv_ok = with_scheme(inv_scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    if constexpr (S == kHighest) {
      dft_inverse_f32_kernel<<<dim3(cdiv(n, kBN), cdiv(T, kBM), B), kThreads, 0, stream>>>(
          buf.p.spec, buf.cos, buf.sin, n_bins, inv_epi);
      err = cudaGetLastError();
    } else {
      err = launch_split_gemm<S>(buf.p.hi, buf.p.lo, buf.inv_hi, buf.inv_lo, B, T, 2 * f_pad,
                                 n_pad, n, inv_epi, stream);
    }
  });
  if (!inv_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const size_t total = static_cast<size_t>(B) * lp;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  ola_kernel<<<blocks, threads, 0, stream>>>(buf.frames, inv_env, x_out, B, T, n, hop, lp, p_amt,
                                             e, pad_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace specinv
