#!/usr/bin/env python3
"""What the direct-DFT engine's summation and thread tile buy and cost on one
CUDA card.

``csrc/dft_iter.cuh`` adds each stage's products into float32 sums in
registers: in the bf16 schemes each 64-deep stage's tensor-core result, in
'highest' each 32-deep box's FFMA chain.  This script builds, beside the
engine as it is, copies patched from the sources under
``build/dft_variants/`` and reads for each, in turns: the distance of ``|S|``
after one Griffin-Lim iteration at BASELINE config 1 from the float64 plain
version (beside the plain float32 version's), and the device time of the
forward and inverse products (``torch.profiler``, 20 iterations) at config 1
and at n_fft 400 / hop 160.  The variants:

- HIGH: per-stage sums (as it is); one accumulator over the whole
  contraction.
- HIGHEST: 8 x 8 outputs a thread, a 32-deep FMA chain per box (as it
  is); table prefetch (the next chunk's table values read during a
  chunk's products); chunks unrolled (the box's loop of chunks written
  out); 64-deep chains (a group's boxes of two stages); 8 x 4 (eight warps
  on one depth, no split); one FMA chain over each group's whole
  contraction; and two ceilings whose results are wrong on purpose: no
  refill (the ring is loaded once and its first stages read again, so no
  TMA traffic after the start) and one chunk (every 16-byte read of a box
  at its first chunk, so the reads no longer depend on the chunk).

Run from the root of a checkout: ``python3 scripts/torch_dft_variants.py
[--only high|highest]``.  It needs one card and nvcc, and prints the card's
name and power limit last.  A patch that stops releasing a stage would
deadlock the card: the ceilings keep every release.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from specinv_tpu_torch.ops.cuda import _build, gl_fused  # noqa: E402

# The bf16 product warpgroup's loop with per-stage sums, and its
# replacement: one accumulator over every stage of a tile, each stage
# released once the next one's products are in flight (the last once the
# tile's products are done).
STAGE_SUMS = """      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        const int s = g % kPersistStages;
        issue_stage<S>(acc, ring + s * kStageBytes, smem_u32(&full[s]), (g / kPersistStages) & 1);
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int q = 0; q < 64; ++q) sum[q] = __fadd_rn(sum[q], acc[q]);
        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      }
"""
ONE_ACCUMULATOR = """#pragma unroll
      for (int q = 0; q < 64; ++q) acc[q] = 0.0f;
      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        const int s = g % kPersistStages;
        issue_stage<S>(acc, ring + s * kStageBytes, smem_u32(&full[s]), (g / kPersistStages) & 1);
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(g - 1) % kPersistStages]));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(smem_u32(&empty[(g - 1) % kPersistStages]));
#pragma unroll
      for (int q = 0; q < 64; ++q) sum[q] = acc[q];
"""
# HIGHEST: the box's chain and the group's sums
FFMA_FIRST = "d = kFirst && q == 0 ? __fmul_rn(x, y) : __fmaf_rn(x, y, d);"
CHUNK_LOOP = "#pragma unroll 1\n  for (int c = 1; c < kBoxK / 4; ++c) {"
# the box's chunks with each chunk's table values read just before its
# products, and with the next chunk's read ahead (two register sets)
BOX_PAIRS = """  float4 b0[kFfmaCols], b1[kFfmaCols];
  load_table_chunk(b0, b, 0, tc);
  load_table_chunk(b1, b, 1, tc);
  ffma_chunk<kFirst>(acc, a, b0, 0, tr);
#pragma unroll 1
  for (int c = 1; c < 7; c += 2) {
    load_table_chunk(b0, b, c + 1, tc);
    ffma_chunk<false>(acc, a, b1, c, tr);
    load_table_chunk(b1, b, c + 2, tc);
    ffma_chunk<false>(acc, a, b0, c + 1, tr);
  }
  ffma_chunk<false>(acc, a, b1, 7, tr);
"""
BOX_ONE_BY_ONE = """  float4 bv[kFfmaCols];
  load_table_chunk(bv, b, 0, tc);
  ffma_chunk<kFirst>(acc, a, bv, 0, tr);
#pragma unroll 1
  for (int c = 1; c < kBoxK / 4; ++c) {
    load_table_chunk(bv, b, c, tc);
    ffma_chunk<false>(acc, a, bv, c, tr);
  }
"""
FFMA_SUMS = "for (int i = 0; i < kFfmaOut; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);"
# a group's chain over one box, or over its boxes of kFfmaGroups stages
# (64 deep, a bf16 stage's depth), added into the sums after the last
CHAIN_32 = "      if (q == 0) {"
CHAIN_64 = "      if (q == 0 && kt % kFfmaGroups == 0) {"
SUMS_32 = """#pragma unroll
    for (int i = 0; i < kFfmaOut; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
  }"""
SUMS_64 = """    if ((kt + 1) % kFfmaGroups == 0 || kt + 1 == k_tiles) {
#pragma unroll
      for (int i = 0; i < kFfmaOut; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    }
  }"""
FFMA_DECL = "float sum[kFfmaOut], acc[kFfmaOut];"
PRODUCER_LOOP = """      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait"""
FFMA_WAIT = "    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);\n    const unsigned char* stage"
VARIANTS = {  # name: (tier, patches)
    "high, per-stage sums": ("high", []),
    "high, one accumulator": ("high", [(STAGE_SUMS, ONE_ACCUMULATOR),
                                       ("wgmma_m64n128k16(acc, ah, bh, kk > 0);",
                                        "wgmma_m64n128k16(acc, ah, bh, 1);")]),
    "highest, 8 x 8 (as it is)": ("highest", []),
    "highest, table prefetch": ("highest", [(BOX_ONE_BY_ONE, BOX_PAIRS)]),
    "highest, chunks unrolled": ("highest", [(CHUNK_LOOP, CHUNK_LOOP.replace(" 1\n", "\n"))]),
    "highest, 64-deep chains": ("highest", [(CHAIN_32, CHAIN_64), (SUMS_32, SUMS_64)]),
    "highest, 8 x 4": ("highest", [("constexpr int kFfmaCols = 8;",
                                    "constexpr int kFfmaCols = 4;")]),
    "highest, one chain": ("highest", [(FFMA_FIRST, "d = __fmaf_rn(x, y, d);"),
                                       (FFMA_SUMS, "for (int i = 0; i < kFfmaOut; ++i) "
                                                   "sum[i] = acc[i];"),
                                       (FFMA_DECL, "float sum[kFfmaOut], acc[kFfmaOut] = {};")]),
    "highest ceiling, no refill": ("highest", [
        (PRODUCER_LOOP, PRODUCER_LOOP.replace("kt < k_tiles", "kt < k_tiles && kt < kStages")),
        (FFMA_WAIT, FFMA_WAIT.replace("    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);",
                                      "    if (kt < kStages) mbar_wait(smem_u32(&full[s]), 0);"))]),
    "highest ceiling, one chunk": ("highest", [
        ("((c ^ (tr + 4 * (i & 1))) << 4)", "((tr + 4 * (i & 1)) << 4)"),
        ("((c ^ tc) << 4)", "(tc << 4)")]),
}


def build(name: str, patches) -> ctypes.CDLL:
    """The Griffin-Lim direct-DFT entry point built from a patched copy of
    the sources."""
    out = ROOT / "build" / "dft_variants" / "".join(ch if ch.isalnum() else "_" for ch in name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.SRC_DIR, out)
    text = (out / "dft_iter.cuh").read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the engine no longer has the patched text once")
        text = text.replace(old, new)
    (out / "dft_iter.cuh").write_text(text)
    nvcc = _build._nvcc()
    objs = [out / f"{src}.o" for src in ("gl_fused", "fft")]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(out), "-c", "-o", str(o),
                               str(out / f"{o.stem}.cu")]) for o in objs]
    if any(p.wait() for p in procs):
        raise SystemExit(f"{name}: nvcc failed")
    lib = out / "lib.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
                   check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.specinv_gl_dft_iteration.argtypes = _build._SIGNATURES["specinv_gl_dft_iteration"]
    cdll.specinv_gl_dft_iteration.restype = ctypes.c_int
    cdll.specinv_error_string.argtypes = [ctypes.c_int]
    cdll.specinv_error_string.restype = ctypes.c_char_p
    return cdll


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=("high", "highest"), default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dft_variants: needs a CUDA card")
    chosen = {k: v for k, v in VARIANTS.items() if args.only in (None, v[0])}
    names = list(chosen)
    jobs = [(name, chosen[name][1]) for name in names]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as pool:  # nvcc runs in processes
        libs = dict(zip(names, pool.map(lambda job: build(*job), jobs)))
    dev = torch.device("cuda", 0)
    lr = 0.99 / 1.99
    cfg1, st1 = cs.kernel_state(cs.N_FFT, cs.HOP, cs.N_SAMPLES, 1, dev)
    cfg7, st7 = cs.kernel_state(cs.C7_N_FFT, cs.C7_HOP, cs.N_SAMPLES, 1, dev)
    x, s, t, w, e = st1
    wide = [a.double() for a in (x, t, w, e)]
    tiers = sorted({tier for tier, _ in chosen.values()})
    a64, top = {}, {}
    for tier in tiers:
        a64[tier] = gl_fused.fused_gl_iteration_reference(
            wide[0], s.to(torch.complex128), *wide[1:], lr, cfg1, tier)[1]
        top[tier] = a64[tier].abs().max()
        plain = gl_fused.fused_gl_iteration_reference(x, s, t, w, e, lr, cfg1, tier)[1]
        print(f"{tier}: plain float32 |S| from float64: "
              f"{float((plain.double() - a64[tier]).abs().max() / top[tier]):.3e}", flush=True)
    for turn in range(2):
        for name, cdll in libs.items():
            tier = chosen[name][0]
            _build.library = lambda cdll=cdll: cdll
            mag = gl_fused.fused_gl_iteration(x, s, t, w, e, lr, cfg1, tier)[1]
            err = float((mag.double() - a64[tier]).abs().max() / top[tier])
            times = []
            for cfg, st in ((cfg1, st1), (cfg7, st7)):
                def run(cfg=cfg, st=st, tier=tier):
                    return gl_fused.fused_gl_iteration(*st, lr, cfg, tier)
                run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        run()
                    torch.cuda.synchronize()
                us = {("forward" if "Forward" in k.key else "inverse"): k.device_time_total / 20
                      for k in prof.key_averages() if "split_gemm" in k.key}
                times.append(f"{us['forward']:.2f} / {us['inverse']:.2f}")
            print(f"turn {turn}, {name}: |S| from float64 {err:.3e}; forward / inverse "
                  f"product {times[0]} us at config 1, {times[1]} us at 400/160", flush=True)
    print(cs.smi_line())


if __name__ == "__main__":
    main()
