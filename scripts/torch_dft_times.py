#!/usr/bin/env python3
"""Time the direct-DFT kernels E and F on one CUDA card, to compare two
trees of the package in one call.

Run from the root of a checkout: ``python3 scripts/torch_dft_times.py
[--root TREE]``, where ``TREE`` holds the ``specinv_tpu_torch`` package to
time (default: this checkout), so that an unpacked older commit is timed by
the same script, e.g. parent, change, change, parent in one call.  It fails
without a card.

At BASELINE config 1's shapes (a 10 s speech-like clip, seed 0, n_fft 2048,
hop 512, hann; 431 frames, B = 1), from the SPSI seed as chip_smoke.py
builds it: one iteration of ``gl_fused.fused_gl_iteration`` (E) and of
``admm_fused.fused_admm_iteration`` (F, rho 0.1) at HIGH and at HIGHEST,
as a CUDA graph of 20 calls replayed 10 times and as called (CUDA events,
mean of 20); the same at HIGH on that clip at n_fft 400, hop 160 (1,379
frames); and ``|S|`` after one HIGHEST iteration of E against the
float64 plain version (beside the plain float32 version's distance).  The
last lines are the card's name and power limit and one JSON object with
every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N_FFT, HOP, N_SAMPLES, RHO = 2048, 512, 220500, 0.1
LR = 0.99 / 1.99


def called_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="tree that holds the specinv_tpu_torch package")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dft_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import specinv_tpu_torch as st
    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.models.phase_init import phase_init_tm
    from specinv_tpu_torch.ops import stft as stft_ops
    from specinv_tpu_torch.ops import twins
    from specinv_tpu_torch.ops.cuda import _build, admm_fused, gl_fused
    from specinv_tpu_torch.ops.framing import pad_center
    from specinv_tpu_torch.utils.corpus import make_speech_like

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"package {st.__file__}", flush=True)
    _build.library()
    clip = torch.from_numpy(make_speech_like(N_SAMPLES, seed=0).astype(np.float32)).to(dev)

    def start(n_fft, hop):
        cfg, w = canonicalize(n_fft // 2 + 1, np.float32,
                              window=torch.hann_window(n_fft).numpy(), hop_length=hop)
        win = torch.from_numpy(w).to(dev)
        tgt = stft_ops.stft(clip[None], cfg, win).abs().contiguous()
        seed = phase_init_tm(tgt, cfg).to(torch.complex64)
        T = tgt.shape[-2]
        x_pad = pad_center(stft_ops.istft(seed, cfg, win), cfg).contiguous()
        inv_env = twins.make_inv_env(cfg, win, T, twins.make_geometry(cfg, T))
        return cfg, (x_pad, seed, tgt, win, inv_env)

    cfg, state = start(N_FFT, HOP)
    x_pad, seed, tgt, win, inv_env = state
    out = {}
    for shape, (cfg_s, state_s), tiers in (("", (cfg, state), ("high", "highest")),
                                           (" 400/160", start(400, 160), ("high",))):
        for name, mod, run, scalar, extra in (
                ("gl_fused", gl_fused, "fused_gl_iteration", LR, ()),
                ("admm_fused", admm_fused, "fused_admm_iteration", RHO, (0,))):
            for tier in tiers:
                fn, key = getattr(mod, run), f"{name} {tier}{shape}"

                def call(fn=fn, scalar=scalar, extra=extra, tier=tier, cfg_s=cfg_s,
                         state_s=state_s):
                    return fn(*state_s, scalar, cfg_s, *extra, precision=tier)

                out[key] = {"graph_us": graph_ms(call) * 1000, "called_us": called_ms(call) * 1000}
                print(f"{key}: {out[key]['graph_us']:.2f} us (CUDA graph), "
                      f"{out[key]['called_us']:.2f} us as called", flush=True)

    wide = [t.double() for t in (x_pad, tgt, win, inv_env)]
    a64 = gl_fused.fused_gl_iteration_reference(wide[0], seed.to(torch.complex128), *wide[1:],
                                                LR, cfg, "highest")[1]
    top = a64.abs().max()
    for label, fn in (("kernel", gl_fused.fused_gl_iteration),
                      ("plain", gl_fused.fused_gl_iteration_reference)):
        mag = fn(*state, LR, cfg, precision="highest")[1]
        out[f"highest |S| from float64, {label}"] = float((mag.double() - a64).abs().max() / top)
        print(f"highest |S| from float64, {label}: "
              f"{out[f'highest |S| from float64, {label}']:.3e}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
