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
//   kHighest   a*b                          float32 FFMA on the CUDA cores
//
// with hi = bf16_rn(x), lo = bf16_rn(x - hi) (JAX's astype rounding).
//
// Every scheme: one product with complex parts interleaved.  Both
// products are one real matrix product against M2 (n, 2F), M2[k, 2f] =
// C[k, f] and M2[k, 2f + 1] = -Sn[k, f] (negation is exact):
//
//   S interleaved (T, 2F)  = frames @ M2          K = n
//   frames                 = P interleaved @ M2^T K = 2F
//
// so one output tile of the forward holds both parts of its bins, and the
// inverse is one product of depth 2F instead of two of depth F.  The wrapper
// caches M2 in the layouts the ring reads (ops/cuda/_dft.py
// interleaved_tables): the forward's B operand is M2^T (2F_pad, n_pad), the
// inverse's M2 (n_pad, 2F_pad), each in float32 (kHighest) and split into
// bf16 hi/lo planes, with F_pad = F rounded up to 32 and n_pad = n rounded up
// to 64 and zeros in the pad, so every row is a whole number of 128-byte
// lines.  The data operands are written once per iteration, not once per
// tile: frame_split_kernel writes the framed, windowed signal as float32
// (B, T, n_pad) or as bf16 hi/lo planes (a tensor-map copy cannot frame an
// arbitrary hop: t*hop*4 bytes is 16-byte aligned only when 4 | hop), and
// the forward's epilogue writes P as float32 or hi/lo planes (B, T, 2F_pad)
// with its own zero padding.  The splits are the ones split_bf16 makes of
// the float32 values, so the schemes compute the same function.
//
// Each product computes 64-row x 128-column output tiles of one clip from
// a ring of shared-memory stages that a producer keeps filled by the Tensor
// Memory Accelerator (one 64 x 64 tile of each data half and one 128 x 64
// tile of each table half per stage, 128-byte swizzled, out-of-bounds rows
// zero-filled, completion on an mbarrier per stage).
//
// In a bf16 scheme persistent_split_gemm_kernel runs at every shape, a CTA
// per SM (or per tile, where there are fewer tiles).  A CTA walks its
// tiles, its producer filling a ring of kPersistStages across them, so the
// ring never drains between tiles.  One product warpgroup issues
// wgmma.mma_async m64n128k16 (bf16 in, float32 accumulate) for each whole
// tile, every pass of the scheme on the same stage into one accumulator
// started from zero.  Once a stage's products are done, it adds them into
// float32 sums in registers, rounded to nearest, and releases the stage
// (one arrival per warp on its empty barrier).  Summing per 64-deep stage
// keeps the result as close to float64 as the plain version's: the tensor
// cores' own float32 accumulation over the whole contraction of 2048 lay
// about 24x farther (scripts/torch_dft_variants.py).  It leaves the sums in
// one of two result tiles and goes on to the next tile's products, while
// two epilogue warpgroups, whose loads of that tile's operands ran under
// its products, store it from there as pairs of neighbouring columns, a
// warp on 32 consecutive pairs of one row: in the forward the (re, im) of
// 32 bins.  Shared memory: 3 stages of 48 KB and the two result tiles of
// 33,792 bytes, 216,064 bytes with the ring's alignment.
//
// On an H100 this ran no slower than a CTA per tile (which fills its ring,
// runs its stages and then its epilogue, one after the other) at every
// shape timed, bit for bit the same: 0.96-1.00 of its time at one tile per
// SM or fewer (config 1 and 400/160 at B = 1), 0.83-0.95 at 1.3 to 3.6
// tiles per SM, 0.80 at the Whisper cell's 45.6 (PERF.md section 6).  Two
// warpgroups taking whole tiles in turn, each storing its own (ping-pong),
// ran the Whisper forward slower than a tile per CTA: one warpgroup's
// epilogue of a whole tile outlasted the other's products.
//
// What bounds the products on an H100 at the Whisper cell's shape (32 x
// 3,001 frames, n_fft 400, 'high', |S| written: 6,016 tiles a product):
// the ring's TMA reads, 336 KB a tile from L2 (2.0 GB a product), take
// about 200 us with the epilogues' loads and stores cut, on either product.
// The inverse's light epilogue hides under them (about 230 us a product,
// against 325 on a tile per CTA).  The forward's does not (about 420 us,
// against 550): its Middle and its 0.8 GB of device-memory traffic (the
// state read and written, the target, |S|, P's planes and the frames) run
// at about 1.9 TB/s, and a third epilogue warpgroup gained 4 %.
//
// kHighest runs split_gemm_kernel, a CTA per tile at every shape: its FFMA
// stream bounds it, not its epilogue.  Its ring has kStages of the same
// bytes, and its result tile goes over the spent ring (197,632 bytes with
// the alignment).  It reads the ring with float32 tiles (a stage holds 64
// deep as two 32-float boxes of each operand, the bytes of a bf16 stage)
// and keeps the products exact float32 FFMA on the CUDA cores: TF32 or a
// bf16 split would not compute its function.  Its consumers take more registers than
// the 168 a thread of nine warps gets, so its producer is a whole warpgroup
// that gives its registers to them (setmaxnreg).  A thread owns 8 rows x
// kFfmaCols columns and reads each operand as 16 bytes along k (four
// k-steps per load, as the swizzle lays them out, no bank conflict): 16
// loads per 256 FFMA, against the CUDA-core kernel's 12 or 16 per 32 before
// it.  Four warps cover the 64 x 128 tile at 8 x 8, so the eight consumer
// warps are two groups that split each stage's depth, group g reading box
// g; their sums meet through shared memory in a fixed order at the end (the
// sum of group 0, plus group 1's).  Each box's 32-deep FMA chain starts from
// its first product and is added into the group's float32 sums, as the bf16
// schemes' stages are.  On an H100 what holds it at about two thirds of the
// FP32 rate is the FFMA stream itself: a ring that is never refilled, or
// loads cut to one chunk's, run no faster, and 8 x 4 outputs a thread runs
// slower (scripts/torch_dft_variants.py).  The forward writes P in whatever form
// the inverse's scheme reads, so any (forward, inverse) pair of schemes runs.
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

using bf16 = __nv_bfloat16;

template <int S>
struct SchemeTraits {
  static constexpr bool kBLo = S == kHigh || S == kBf16x2;   // the ah*bl pass
  static constexpr bool kALo = S == kHigh || S == kBf16x2t;  // the al*bh pass
  static constexpr bool kF32 = S == kHighest;                // float32 operands
  using Elem = std::conditional_t<kF32, float, bf16>;        // an operand's element
};

inline bool data_lo(int s) { return s == kHigh || s == kBf16x2t; }

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
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, desc a) * B (16 x 128, desc b) + (accumulate ? d : 0),
// bf16 in, float32 out: the 128 columns of a whole tile.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// The split products on the tensor cores.

constexpr int kTileM = 64;                          // rows (frames) per tile
constexpr int kTileN = 128;                         // columns per tile
constexpr int kTileK = 64;                          // depth per stage: one 128-byte bf16 row
constexpr int kBoxK = 32;                           // float32 depth of one 128-byte row
constexpr int kConsumers = kTileN / 64;             // warpgroups of the epilogue
// kHighest's: kConsumers warpgroups and a whole producer warpgroup, so that
// setmaxnreg can move its registers to them (registers are dealt per
// warpgroup)
constexpr int kFfmaThreads = 128 * kConsumers + 128;
constexpr int kProducerRegs = 40, kFfmaRegs = 232;
static_assert(kProducerRegs * 128 + kFfmaRegs * 128 * kConsumers <= 65536, "one CTA per SM");
constexpr int kStages = 4;  // kHighest's ring
constexpr int kATile = kTileM * kTileK * 2;  // bytes of one data half's tile (one float32 box)
constexpr int kBTile = kTileN * kTileK * 2;  // bytes of one table half's tile (one float32 box)
constexpr int kStageBytes = 2 * kATile + 2 * kBTile;
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + alignment of the ring
constexpr int kLdTile = kTileN + 4;  // float32 result tile of the epilogue, in the ring
static_assert(kGemmSmem <= 227 * 1024, "the ring must fit in shared memory");
static_assert(kTileM * kLdTile * 4 <= kStages * kStageBytes, "the result tile fits the ring");
static_assert(kATile == kTileM * kBoxK * 4 && kBTile == kTileN * kBoxK * 4,
              "a float32 stage is two boxes of each operand in a bf16 stage's place");
// The epilogue's threads: kHighest's consumers, the bf16 products' epilogue
// warpgroups.
constexpr int kEpiThreads = 128 * kConsumers;
// The bf16 products' persistent kernel: one product warpgroup, the
// epilogue warpgroups and a producer warpgroup, whose registers setmaxnreg
// gives to the product warpgroup (setmaxnreg.inc takes only what other
// warpgroups give back); a ring of kPersistStages, and two result tiles
// beside it, since the ring is never spent (the barriers' static shared
// memory counts against the same 227 KB).
constexpr int kPersistThreads = 128 + kEpiThreads + 128;
constexpr int kPersistRegs = 65536 / kPersistThreads;  // each thread's at launch
constexpr int kProductRegs = kPersistRegs + (kPersistRegs - kProducerRegs);
static_assert(kPersistRegs % 8 == 0 && kProductRegs <= 256, "setmaxnreg counts");
constexpr int kPersistStages = 3;
constexpr int kResultBytes = kTileM * kLdTile * 4;
constexpr int kPersistSmem = kPersistStages * kStageBytes + 2 * kResultBytes + 1024;
static_assert(kPersistSmem + 8 * (2 * kPersistStages + 4) <= 227 * 1024,
              "the ring and two result tiles fit in shared memory");

// Waits for a stage and issues its products into acc, every pass of the
// scheme, acc started from zero: a 64 x 64 data tile (hi at stage, lo after
// it) against the 128 x 64 table tile (at stage + 2 kATile, lo kBTile after
// it), 4 k16 steps.
template <int S>
__device__ __forceinline__ void issue_stage(float (&acc)[64], uint32_t stage, uint32_t full_bar,
                                            uint32_t parity) {
  const uint32_t tab = stage + 2 * kATile;
  mbar_wait(full_bar, parity);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t ah = sw128_desc(stage + kk * 32), bh = sw128_desc(tab + kk * 32);
    wgmma_m64n128k16(acc, ah, bh, kk > 0);
    if constexpr (SchemeTraits<S>::kBLo) {
      wgmma_m64n128k16(acc, ah, sw128_desc(tab + kBTile + kk * 32), 1);
    }
    if constexpr (SchemeTraits<S>::kALo) {
      wgmma_m64n128k16(acc, sw128_desc(stage + kATile + kk * 32), bh, 1);
    }
  }
  wgmma_commit();
}

// The producer's loads of stage kt of the tile at (b, m0, n0) into the ring
// stage at stage, complete on bar: the data tiles (rows m0.., hi then lo)
// and the table tiles (rows n0..), lo halves where the scheme reads them,
// or for float32 the stage's second 32-deep box.
template <int S>
__device__ __forceinline__ void load_stage(uint32_t stage, uint32_t bar, const CUtensorMap* a_hi,
                                           const CUtensorMap* a_lo, const CUtensorMap* b_hi,
                                           const CUtensorMap* b_lo, int kt, int m0, int n0,
                                           int b) {
  constexpr bool kF32 = SchemeTraits<S>::kF32;
  constexpr bool kALo = SchemeTraits<S>::kALo || kF32, kBLo = SchemeTraits<S>::kBLo || kF32;
  constexpr uint32_t kBytes = kATile * (kALo ? 2 : 1) + kBTile * (kBLo ? 2 : 1);
  const int k0 = kt * kTileK, k1 = kF32 ? k0 + kBoxK : k0;
  mbar_expect_tx(bar, kBytes);
  tma_load_3d(stage, a_hi, bar, k0, m0, b);
  if constexpr (kALo) tma_load_3d(stage + kATile, a_lo, bar, k1, m0, b);
  tma_load_2d(stage + 2 * kATile, b_hi, bar, k0, n0);
  if constexpr (kBLo) tma_load_2d(stage + 2 * kATile + kBTile, b_lo, bar, k1, n0);
}

// kHighest's thread tile, 8 rows x kFfmaCols columns; kFfmaWarps warps
// cover the tile and the consumer warps form kFfmaGroups groups that split
// each stage's two 32-deep boxes.
constexpr int kFfmaCols = 8;
constexpr int kFfmaOut = 8 * kFfmaCols;
constexpr int kFfmaWarps = 2 * (kTileN / 8) / kFfmaCols;
constexpr int kFfmaGroups = 4 * kConsumers / kFfmaWarps;
static_assert(kFfmaGroups == 1 || kFfmaGroups == 2, "the groups split a stage's two boxes");

// A chunk's 16-byte table reads (k = 4c .. 4c + 3) of this thread's
// kFfmaCols columns: b points at the thread's first row of the table box,
// its columns tc + 8 j.  Chunk c of row r lies at 16 (c ^ (r % 8)) in its
// 128-byte line (the 128-byte swizzle), so a warp's reads hit 8 distinct
// bank groups.
__device__ __forceinline__ void load_table_chunk(float4 (&bv)[kFfmaCols], const unsigned char* b,
                                                 int c, int tc) {
#pragma unroll
  for (int j = 0; j < kFfmaCols; ++j) {
    bv[j] = *reinterpret_cast<const float4*>(b + j * 1024 + ((c ^ tc) << 4));
  }
}

// One chunk of a box's products of this thread's 8 x kFfmaCols outputs into
// acc, against the table values bv; the first product of the box's FMA
// chain is a multiply when kFirst.  Lane = 8 tr + tc takes rows tr + 4 i of
// its warp's block; a points at the thread's first row of the data box,
// whose reads hit 4 distinct bank groups.
template <bool kFirst>
__device__ __forceinline__ void ffma_chunk(float (&acc)[kFfmaOut], const unsigned char* a,
                                           const float4 (&bv)[kFfmaCols], int c, int tr) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 av =
        *reinterpret_cast<const float4*>(a + i * 512 + ((c ^ (tr + 4 * (i & 1))) << 4));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = q == 0 ? av.x : q == 1 ? av.y : q == 2 ? av.z : av.w;
#pragma unroll
      for (int j = 0; j < kFfmaCols; ++j) {
        const float y = q == 0 ? bv[j].x : q == 1 ? bv[j].y : q == 2 ? bv[j].z : bv[j].w;
        float& d = acc[i * kFfmaCols + j];
        d = kFirst && q == 0 ? __fmul_rn(x, y) : __fmaf_rn(x, y, d);
      }
    }
  }
}

// A 32-deep box's products into acc (its FMA chain, started from its first
// product when kFirst).  The chunks after the first run as a loop: unrolled
// they ran slower (scripts/torch_dft_variants.py).
template <bool kFirst>
__device__ __forceinline__ void ffma_box(float (&acc)[kFfmaOut], const unsigned char* a,
                                         const unsigned char* b, int tr, int tc) {
  float4 bv[kFfmaCols];
  load_table_chunk(bv, b, 0, tc);
  ffma_chunk<kFirst>(acc, a, bv, 0, tr);
#pragma unroll 1
  for (int c = 1; c < kBoxK / 4; ++c) {
    load_table_chunk(bv, b, c, tc);
    ffma_chunk<false>(acc, a, bv, c, tr);
  }
}

// kHighest's consumers: the whole contraction of the tile from the ring
// (stage s at ring + s kStageBytes, data boxes first), the groups' sums
// added in a fixed order, the result left in tile (64 x kLdTile floats over
// the spent ring).  A stage is released once every lane of a warp has read
// its box.
__device__ __forceinline__ void ffma_products(const unsigned char* ring, uint64_t* full,
                                              uint64_t* empty, int k_tiles, float* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / kFfmaWarps, wq = warp % kFfmaWarps;
  const int row0 = (wq / (kFfmaWarps / 2)) * 32 + lane / 8;
  const int col0 = (wq % (kFfmaWarps / 2)) * (8 * kFfmaCols) + lane % 8;
  const int tr = lane / 8, tc = lane % 8;
  float sum[kFfmaOut], acc[kFfmaOut];
#pragma unroll
  for (int i = 0; i < kFfmaOut; ++i) sum[i] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const unsigned char* stage = ring + s * kStageBytes;
#pragma unroll
    for (int q = 0; q < 2 / kFfmaGroups; ++q) {
      const int h = grp + q * kFfmaGroups;
      const unsigned char* a = stage + h * kATile + row0 * 128;
      const unsigned char* b = stage + 2 * kATile + h * kBTile + col0 * 128;
      if (q == 0) {
        ffma_box<true>(acc, a, b, tr, tc);
      } else {
        ffma_box<false>(acc, a, b, tr, tc);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
#pragma unroll
    for (int i = 0; i < kFfmaOut; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
  }
  // the last group's sums first, then each group before it adds its own
#pragma unroll
  for (int g = kFfmaGroups - 1; g >= 0; --g) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
    if (grp == g) {
#pragma unroll
      for (int i = 0; i < kFfmaOut; ++i) {
        float& t = tile[(row0 + 4 * (i / kFfmaCols)) * kLdTile + col0 + 8 * (i % kFfmaCols)];
        t = g == kFfmaGroups - 1 ? sum[i] : __fadd_rn(sum[i], t);
      }
    }
  }
}

// The epilogue: thread tid of kEpiThreads takes column pair tid % 64 of the
// tile's rows tid / 64 + kRowStep q, q < kThreadRows.  load_rows loads their
// operands, every one first (one round trip to memory); store_rows stores
// the rows from the float32 result tile (64 x kLdTile).
constexpr int kRowStep = kEpiThreads / (kTileN / 2), kThreadRows = kTileM / kRowStep;

template <class Epilogue>
__device__ __forceinline__ void load_rows(const Epilogue& epi,
                                          typename Epilogue::Operands (&ops)[kThreadRows],
                                          int tid, int b, int m0, int n0, int rows) {
  const int r0 = m0 + tid / (kTileN / 2), c = n0 + 2 * (tid % (kTileN / 2));
#pragma unroll
  for (int q = 0; q < kThreadRows; ++q) {
    const int r = r0 + kRowStep * q;
    if (r < rows) ops[q] = epi.load(b, r, c);
  }
}

template <class Epilogue>
__device__ __forceinline__ void store_rows(const Epilogue& epi, const float* tile,
                                           const typename Epilogue::Operands (&ops)[kThreadRows],
                                           int tid, int b, int m0, int n0, int rows) {
  const int cp = tid % (kTileN / 2), c = n0 + 2 * cp;
#pragma unroll
  for (int q = 0; q < kThreadRows; ++q) {
    const int rl = tid / (kTileN / 2) + kRowStep * q;
    const float2 v = *reinterpret_cast<const float2*>(tile + rl * kLdTile + 2 * cp);
    if (m0 + rl < rows) epi.store(b, m0 + rl, c, v.x, v.y, ops[q]);
  }
}

// C (rows of clip blockIdx.z, columns) = A (B, rows, K) @ B^T (columns, K)
// in kHighest, a CTA per tile: both operands K-major float32 behind tensor
// maps (the lo maps are the hi ones); the epilogue gets each thread's pairs
// of neighbouring columns.  rows masks the tile's last row; k_tiles = K /
// kTileK.
template <int S, class Epilogue>
__global__ void __launch_bounds__(kFfmaThreads, 1) split_gemm_kernel(
    const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
    const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
    int rows, int k_tiles, const Epilogue epi) {
  static_assert(SchemeTraits<S>::kF32, "kHighest");
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

  if (warp >= 4 * kConsumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(smem_u32(&empty[s]), ((kt / kStages) - 1) & 1);
        load_stage<S>(ring + s * kStageBytes, smem_u32(&full[s]), &a_hi, &a_lo, &b_hi, &b_lo, kt,
                      m0, n0, b);
      }
    }
    return;
  }

  unsigned char* ring_p = gemm_smem + (ring - smem_u32(gemm_smem));
  float* tile = reinterpret_cast<float*>(ring_p);
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kFfmaRegs));
  ffma_products(ring_p, full, empty, k_tiles, tile);
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  typename Epilogue::Operands ops[kThreadRows];
  load_rows(epi, ops, threadIdx.x, b, m0, n0, rows);
  store_rows(epi, tile, ops, threadIdx.x, b, m0, n0, rows);
}

// The same products in a bf16 scheme: a persistent CTA per SM (or per tile)
// walks the tiles i = blockIdx.x, blockIdx.x + gridDim.x, ... of the
// list whose column tile runs fastest, then the row tile, then the clip
// (tiles = n_tiles * m_tiles * B), so that the CTAs on one row block at a
// time share its data slab in L2.  Its warps specialise: the producer
// fills the ring across tiles, so it never drains; the product warpgroup
// runs each whole 64 x 128 tile (m64n128k16), adds each stage's products
// into float32 sums in stage order, and leaves the sums in one of two
// result tiles; the kConsumers epilogue warpgroups load a tile's operands
// while its products run, then store it from its result tile while the
// next tile's products run.  Barriers: done[r] (the sums are
// in result tile r) and freed[r] (its epilogue has read it), one arrival
// per thread.
template <int S, class Epilogue>
__global__ void __launch_bounds__(kPersistThreads, 1) persistent_split_gemm_kernel(
    const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
    const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
    int rows, int k_tiles, int n_tiles, int m_tiles, int tiles, const Epilogue epi) {
  static_assert(!SchemeTraits<S>::kF32, "a bf16 scheme");
  extern __shared__ unsigned char gemm_smem[];
  __shared__ __align__(8) uint64_t full[kPersistStages], empty[kPersistStages], done[2], freed[2];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  float* const results = reinterpret_cast<float*>(gemm_smem + (ring - smem_u32(gemm_smem)) +
                                                  kPersistStages * kStageBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // tile i's clip, first row and first column
  const auto at = [&](int i) {
    return make_int3(i / n_tiles / m_tiles, i / n_tiles % m_tiles * kTileM, i % n_tiles * kTileN);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPersistStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // the product warpgroup's warps
    }
    for (int r = 0; r < 2; ++r) {
      mbar_init(smem_u32(&done[r]), 128);
      mbar_init(smem_u32(&freed[r]), kEpiThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 + kEpiThreads / 32) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 + kEpiThreads / 32 && lane == 0) {
      int g = 0;  // the ring's stages over every tile
      for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
        const int3 p = at(i);
        for (int kt = 0; kt < k_tiles; ++kt, ++g) {
          const int s = g % kPersistStages;
          if (g >= kPersistStages) mbar_wait(smem_u32(&empty[s]), (g / kPersistStages - 1) & 1);
          load_stage<S>(ring + s * kStageBytes, smem_u32(&full[s]), &a_hi, &a_lo, &b_hi, &b_lo,
                        kt, p.y, p.z, p.x);
        }
      }
    }
    return;
  }
  if (warp < 4) {  // the product warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kProductRegs));
    int g = 0;
    for (int i = blockIdx.x, j = 0; i < tiles; i += gridDim.x, ++j) {
      float sum[64], acc[64];
#pragma unroll
      for (int q = 0; q < 64; ++q) sum[q] = 0.0f;
      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        const int s = g % kPersistStages;
        issue_stage<S>(acc, ring + s * kStageBytes, smem_u32(&full[s]), (g / kPersistStages) & 1);
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int q = 0; q < 64; ++q) sum[q] = __fadd_rn(sum[q], acc[q]);
        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      }
      // register q: row 16 warp + lane/4 + 8 ((q/2) % 2), column 8 (q/4) +
      // 2 (lane % 4) + q % 2
      const int r = j % 2;
      if (j >= 2) mbar_wait(smem_u32(&freed[r]), (j / 2 - 1) & 1);
      float* tile = results + r * (kTileM * kLdTile);
#pragma unroll
      for (int q = 0; q < 64; q += 2) {
        const int row = warp * 16 + lane / 4 + 8 * ((q / 2) % 2), c = 8 * (q / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(tile + row * kLdTile + c) = make_float2(sum[q], sum[q + 1]);
      }
      mbar_arrive(smem_u32(&done[r]));
    }
    return;
  }
  {  // the epilogue warpgroups
    const int tid = threadIdx.x - 128;
    for (int i = blockIdx.x, j = 0; i < tiles; i += gridDim.x, ++j) {
      const int3 p = at(i);
      typename Epilogue::Operands ops[kThreadRows];
      load_rows(epi, ops, tid, p.x, p.y, p.z, rows);
      const int r = j % 2;
      mbar_wait(smem_u32(&done[r]), (j / 2) & 1);
      store_rows(epi, results + r * (kTileM * kLdTile), ops, tid, p.x, p.y, p.z, rows);
      mbar_arrive(smem_u32(&freed[r]));
    }
  }
}

// The framed, windowed signal (B, T, n_pad), zeros at k >= n: float32 (E
// float, lo null), or split into bf16 planes (lo may be null).  A thread
// makes 8 neighbouring values of one frame (16-byte stores).
template <class E>
__global__ void frame_split_kernel(const float* __restrict__ x_pad,
                                   const float* __restrict__ window, E* __restrict__ hi,
                                   E* __restrict__ lo, int B, int T, int n, int n_pad, int hop,
                                   int lp) {
  const int groups = n_pad / 8;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * T * groups) return;
  const size_t row = i / groups;
  const int k0 = static_cast<int>(i % groups) * 8;
  const int b = static_cast<int>(row / T), t = static_cast<int>(row % T);
  const float* xf = x_pad + static_cast<size_t>(b) * lp + static_cast<size_t>(t) * hop;
  const size_t o = row * n_pad + k0;
  __align__(16) float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = k0 + j < n ? __fmul_rn(xf[k0 + j], window[k0 + j]) : 0.0f;
  if constexpr (std::is_same_v<E, float>) {
    reinterpret_cast<uint4*>(hi + o)[0] = reinterpret_cast<const uint4*>(v)[0];
    reinterpret_cast<uint4*>(hi + o)[1] = reinterpret_cast<const uint4*>(v)[1];
  } else {
    __align__(16) bf16 h[8], l[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = __float2bfloat16_rn(v[j]);
      l[j] = __float2bfloat16_rn(__fsub_rn(v[j], __bfloat162float(h[j])));
    }
    *reinterpret_cast<uint4*>(hi + o) = *reinterpret_cast<const uint4*>(h);
    if (lo != nullptr) *reinterpret_cast<uint4*>(lo + o) = *reinterpret_cast<const uint4*>(l);
  }
}

// Where the forward writes P, interleaved (re, im) planes (B, T, 2 F_pad):
// bf16 halves where hi is set (lo may be null), else float32 (for a
// kHighest inverse).
struct POut {
  float* f32;
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
    put_p(row, c, out);
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

  // P's bin at column pair c of P's row, in the form the inverse reads.
  __device__ __forceinline__ void put_p(size_t row, int c, float2 out) const {
    if (p.hi != nullptr) {
      const bf16 hr = __float2bfloat16_rn(out.x), hi_ = __float2bfloat16_rn(out.y);
      *reinterpret_cast<__nv_bfloat162*>(p.hi + row * 2 * f_pad + c) = __halves2bfloat162(hr, hi_);
      if (p.lo != nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(p.lo + row * 2 * f_pad + c) = __halves2bfloat162(
            __float2bfloat16_rn(__fsub_rn(out.x, __bfloat162float(hr))),
            __float2bfloat16_rn(__fsub_rn(out.y, __bfloat162float(hi_))));
      }
    } else {
      *reinterpret_cast<float2*>(p.f32 + row * 2 * f_pad + c) = out;
    }
  }

  // zeros at the pad's column pair c of P's planes
  __device__ __forceinline__ void zero_p(size_t row, int c) const {
    if (p.hi != nullptr) {
      const __nv_bfloat162 z = __floats2bfloat162_rn(0.0f, 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(p.hi + row * 2 * f_pad + c) = z;
      if (p.lo != nullptr) *reinterpret_cast<__nv_bfloat162*>(p.lo + row * 2 * f_pad + c) = z;
    } else {
      *reinterpret_cast<float2*>(p.f32 + row * 2 * f_pad + c) = float2{};
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

// A tensor map of a bf16 or float32 array (planes, rows, cols), of rank 3,
// or of rank 2 for a matrix (planes 1), read in boxes of one 128-byte row
// (kTileK bf16 or kBoxK float32 columns) x box_rows rows, 128-byte
// swizzled; rows past the end read as zeros.
template <class E>
inline bool make_map(CUtensorMap* map, int rank, const E* base, int planes, int rows, int cols,
                     int box_rows) {
  static_assert(std::is_same_v<E, bf16> || std::is_same_v<E, float>, "bf16 or float32");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || base == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * sizeof(E),
                                 static_cast<cuuint64_t>(cols) * rows * sizeof(E)};
  const cuuint32_t box[3] = {128 / sizeof(E), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                std::is_same_v<E, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                static_cast<cuuint32_t>(rank), const_cast<E*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One product in the scheme S: out[b] (rows, cols) = a[b] (rows, K) @
// tab^T (cols, K) with a (B, rows, K) and tab (tab_rows, K) bf16 halves
// (lo may be null where the scheme reads none), or float32 for kHighest
// (lo null).  K is a multiple of kTileK.  A bf16 scheme runs
// persistent_split_gemm_kernel on a CTA per SM of the current device (or
// per tile, where there are fewer), kHighest split_gemm_kernel on a CTA per
// tile.
template <int S, class Epilogue>
cudaError_t launch_split_gemm(const typename SchemeTraits<S>::Elem* a_hi,
                              const typename SchemeTraits<S>::Elem* a_lo,
                              const typename SchemeTraits<S>::Elem* t_hi,
                              const typename SchemeTraits<S>::Elem* t_lo, int B, int rows, int K,
                              int tab_rows, int cols, const Epilogue& epi, cudaStream_t stream) {
  CUtensorMap m_ahi, m_alo, m_bhi, m_blo;
  const bool ok =
      make_map(&m_ahi, 3, a_hi, B, rows, K, kTileM) &&
      make_map(&m_alo, 3, SchemeTraits<S>::kALo ? a_lo : a_hi, B, rows, K, kTileM) &&
      make_map(&m_bhi, 2, t_hi, 1, tab_rows, K, kTileN) &&
      make_map(&m_blo, 2, SchemeTraits<S>::kBLo ? t_lo : t_hi, 1, tab_rows, K, kTileN);
  if (!ok) return cudaErrorInvalidValue;
  const int n_tiles = static_cast<int>(cdiv(cols, kTileN));
  const int m_tiles = static_cast<int>(cdiv(rows, kTileM));
  if constexpr (SchemeTraits<S>::kF32) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        split_gemm_kernel<S, Epilogue>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    if (attr != cudaSuccess) return attr;
    split_gemm_kernel<S, Epilogue><<<dim3(n_tiles, m_tiles, B), kFfmaThreads, kGemmSmem, stream>>>(
        m_ahi, m_alo, m_bhi, m_blo, rows, K / kTileK, epi);
  } else {
    static const cudaError_t attr =
        cudaFuncSetAttribute(persistent_split_gemm_kernel<S, Epilogue>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kPersistSmem);
    if (attr != cudaSuccess) return attr;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int tiles = n_tiles * m_tiles * B;
    persistent_split_gemm_kernel<S, Epilogue>
        <<<tiles < sms ? tiles : sms, kPersistThreads, kPersistSmem, stream>>>(
            m_ahi, m_alo, m_bhi, m_blo, rows, K / kTileK, n_tiles, m_tiles, tiles, epi);
  }
  return cudaGetLastError();
}

// The device buffers of one iteration.  fwd (2 F_pad, n_pad) and inv
// (n_pad, 2 F_pad) are M2^T and M2, in float32 for kHighest and as bf16
// halves (lo may be null where no scheme of the call reads it).  The
// forward's frames (B, T, n_pad) are frame_f32 for kHighest, else the split
// frame_hi/lo (null where the forward reads none); p is what the inverse
// reads.
struct Buffers {
  const float* fwd_f32;
  const float* inv_f32;
  const bf16* fwd_hi;
  const bf16* fwd_lo;
  const bf16* inv_hi;
  const bf16* inv_lo;
  float* frame_f32;
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
  if (inv_scheme == kHighest ? buf.p.f32 == nullptr || buf.p.hi != nullptr
                             : buf.p.hi == nullptr || (data_lo(inv_scheme) && buf.p.lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fwd_scheme == kHighest ? buf.frame_f32 == nullptr : buf.frame_hi == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ForwardEpilogue<Middle> fwd_epi{state_in, state_out, target, wts, mag, buf.p,
                                        T, n_bins, f_pad, valid_t, middle};
  cudaError_t err = cudaSuccess;
  const bool fwd_ok = with_scheme(fwd_scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    const size_t groups = static_cast<size_t>(B) * T * (n_pad / 8);
    const unsigned blocks = static_cast<unsigned>((groups + 255) / 256);
    if constexpr (SchemeTraits<S>::kF32) {
      frame_split_kernel<float><<<blocks, 256, 0, stream>>>(x_in, window, buf.frame_f32, nullptr,
                                                            B, T, n, n_pad, hop, lp);
      err = cudaGetLastError();
      if (err == cudaSuccess) {
        err = launch_split_gemm<S>(buf.frame_f32, nullptr, buf.fwd_f32, nullptr, B, T, n_pad,
                                   2 * f_pad, 2 * f_pad, fwd_epi, stream);
      }
    } else {
      frame_split_kernel<bf16><<<blocks, 256, 0, stream>>>(
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
    if constexpr (SchemeTraits<S>::kF32) {
      err = launch_split_gemm<S>(buf.p.f32, nullptr, buf.inv_f32, nullptr, B, T, 2 * f_pad, n_pad,
                                 n, inv_epi, stream);
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
