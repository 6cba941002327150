#!/usr/bin/env python3
"""What the per-stage float32 sums of the direct-DFT engine buy and cost on
one CUDA card.

``csrc/dft_iter.cuh``'s split products add each 64-deep stage's tensor-core
result into float32 sums in registers.  This script builds, beside the
engine as it is, a copy whose consumers keep one tensor-core accumulator
over the whole contraction instead (patched from the sources under
``build/dft_variants/``), and reads for each, in turns: the distance of
``|S|`` after one Griffin-Lim iteration at BASELINE config 1 (HIGH) from the
float64 plain version, beside the plain float32 version's, and the device
time of the forward and inverse products (``torch.profiler``, 20 iterations)
at config 1 and at n_fft 400 / hop 160.

Run from the root of a checkout: ``python3 scripts/torch_dft_variants.py``.
It needs one card and nvcc, and prints the card's name and power limit last.
"""
from __future__ import annotations

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

# The consumers' loop with per-stage sums, and its replacement: one
# accumulator over every stage, each stage released once the next one's
# products are in flight.
STAGE_SUMS = """  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    issue_stage<S>(acc, ring + s * kStageBytes, b_off, smem_u32(&full[s]), (kt / kStages) & 1);
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }
"""
ONE_ACCUMULATOR = """#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    issue_stage<S>(acc, ring + s * kStageBytes, b_off, smem_u32(&full[s]), (kt / kStages) & 1);
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % kStages]));
  }
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = acc[i];
"""
PATCHES = {
    "per-stage sums": [],
    "one accumulator": [(STAGE_SUMS, ONE_ACCUMULATOR),
                        ("wgmma_m64n64k16(acc, ah, bh, kk > 0);",
                         "wgmma_m64n64k16(acc, ah, bh, 1);")],
}


def build(name: str, patches) -> ctypes.CDLL:
    """The Griffin-Lim direct-DFT entry point built from a patched copy of
    the sources."""
    out = ROOT / "build" / "dft_variants" / name.replace(" ", "_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.SRC_DIR, out)
    text = (out / "dft_iter.cuh").read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{name}: the engine no longer has the patched text")
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
    if not torch.cuda.is_available():
        raise SystemExit("torch_dft_variants: needs a CUDA card")
    libs = {name: build(name, patches) for name, patches in PATCHES.items()}
    dev = torch.device("cuda", 0)
    lr = 0.99 / 1.99
    cfg1, st1 = cs.kernel_state(cs.N_FFT, cs.HOP, cs.N_SAMPLES, 1, dev)
    cfg7, st7 = cs.kernel_state(cs.C7_N_FFT, cs.C7_HOP, cs.N_SAMPLES, 1, dev)
    x, s, t, w, e = st1
    wide = [a.double() for a in (x, t, w, e)]
    a64 = gl_fused.fused_gl_iteration_reference(wide[0], s.to(torch.complex128), *wide[1:], lr,
                                                cfg1)[1]
    plain = gl_fused.fused_gl_iteration_reference(x, s, t, w, e, lr, cfg1)[1]
    top = a64.abs().max()
    print(f"plain float32 |S| from float64: {float((plain.double() - a64).abs().max() / top):.3e}")
    for turn in range(2):
        for name, cdll in libs.items():
            _build.library = lambda cdll=cdll: cdll
            mag = gl_fused.fused_gl_iteration(x, s, t, w, e, lr, cfg1)[1]
            err = float((mag.double() - a64).abs().max() / top)
            times = []
            for cfg, st in ((cfg1, st1), (cfg7, st7)):
                def run(cfg=cfg, st=st):
                    return gl_fused.fused_gl_iteration(*st, lr, cfg)
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
