#!/usr/bin/env python3
"""Time the frame launches of the whole-run kernels A and C and the
stand-alone transform B on one CUDA card, to compare two trees of the
package in one call.

Run from the root of a checkout: ``python3 scripts/torch_frame_times.py
[--root TREE]``, where ``TREE`` holds the ``specinv_tpu_torch`` package to
time (default: this checkout), so that an unpacked older commit is timed by
the same script, e.g. parent, change, change, parent in one call.  It fails
without a card.

On a 10 s speech-like clip (seed 0, n_fft 2048, hop 512, hann; 431 frames):
``griffin_lim`` and ``ADMM`` (rho 0.1) through ``backend='kernel'``,
marginal microseconds per iteration from CUDA events ((t(200) - t(100)) /
100, median of 3), and one 100-iteration call of the whole-run wrappers per
iteration; ``frame_kernel`` and ``ola_kernel`` device microseconds per
launch from ``torch.profiler`` over a 50-iteration wrapper call.  At the
sequence-parallel path's world-1 shape (25843 frames, seeded random state),
one raw launch of A and of C (CUDA events, mean of 20) and its
``frame_kernel`` device time.  B: forward plus inverse of 431 x 2048 frames
as a CUDA graph of 20 calls, beside the same graph of ``torch.fft``.  The
last lines are the card's name and power limit and one JSON object with
every number.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N_FFT, HOP, N_SAMPLES, RHO, SEQ_FRAMES = 2048, 512, 220500, 0.1, 25843
LR = 0.99 / 1.99


def event_ms(fn, reps: int = 1) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def marginal_us(fn) -> float:
    """(t(200) - t(100)) / 100 in microseconds, medians of 3, after a warm-up."""
    fn(100)
    t = {100: [], 200: []}
    for _ in range(3):
        for n in (100, 200):
            t[n].append(event_ms(lambda: fn(n)))
    return (float(np.median(t[200])) - float(np.median(t[100]))) / 100 * 1000


def graph_us(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device microseconds of ``fn()`` captured ``reps`` times in one
    CUDA graph, replayed ``replays`` times."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return event_ms(graph.replay, replays) / reps * 1000


def kernel_us(fn) -> dict:
    """Device microseconds per launch of each kernel whose name holds
    ``frame_kernel`` or ``ola_kernel``, over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, count = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in ("frame_kernel", "ola_kernel"):
            if name in e.name:
                total[name] += e.time_range.elapsed_us()
                count[name] += 1
    return {name: total[name] / count[name] for name in total}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="tree that holds the specinv_tpu_torch package")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_frame_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import specinv_tpu_torch as st
    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.models.phase_init import phase_init_tm
    from specinv_tpu_torch.ops import stft as stft_ops
    from specinv_tpu_torch.ops import twins
    from specinv_tpu_torch.ops.cuda import _build, admm_fullrun, fft, gl_fullrun
    from specinv_tpu_torch.ops.framing import pad_center
    from specinv_tpu_torch.utils.corpus import make_speech_like

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"package {st.__file__}", flush=True)
    _build.library()
    window = torch.hann_window(N_FFT, device=dev)
    clip = torch.from_numpy(make_speech_like(N_SAMPLES, seed=0).astype(np.float32)).to(dev)
    mag = st.stft(clip, N_FFT, hop_length=HOP, window=window).abs()
    kw = dict(tol=0.0, hop_length=HOP, window=window, verbose=False, backend="kernel")

    # the whole-run wrappers' state at config 1, as chip_smoke.py builds it
    cfg, w = canonicalize(N_FFT // 2 + 1, np.float32, window=torch.hann_window(N_FFT).numpy(),
                          hop_length=HOP)
    win = torch.from_numpy(w).to(dev)
    tgt = stft_ops.stft(clip[None], cfg, win).abs().contiguous()
    seed = phase_init_tm(tgt, cfg).to(torch.complex64)
    T = tgt.shape[-2]
    x_pad = pad_center(stft_ops.istft(seed, cfg, win), cfg).contiguous()
    inv_env = twins.make_inv_env(cfg, win, T, twins.make_geometry(cfg, T))

    # the world-1 shape of the sequence-parallel path, from a seeded state
    gen = torch.Generator(device=dev).manual_seed(0)
    F = N_FFT // 2 + 1
    x_seq = 0.1 * torch.randn((1, (SEQ_FRAMES - 1) * HOP + N_FFT), device=dev, generator=gen)
    s_seq = torch.randn((1, SEQ_FRAMES, F), dtype=torch.complex64, device=dev, generator=gen)
    t_seq = s_seq.abs().contiguous()

    res = {}
    for name, public, mod, run, it, scalar in (
            ("griffin_lim", lambda n: st.griffin_lim(mag, max_iter=n, **kw), gl_fullrun,
             "fused_gl_run", "fused_gl_iteration", LR),
            ("ADMM", lambda n: st.ADMM(mag, max_iter=n, rho=RHO, **kw), admm_fullrun,
             "fused_admm_run", "fused_admm_iteration", RHO)):
        res[f"{name} us/iter"] = marginal_us(public)
        call = getattr(mod, run)
        res[f"{name} call us/iter"] = event_ms(
            lambda: call(x_pad, seed, tgt, win, inv_env, scalar, cfg, 100), 3) * 10
        res[f"{name} device us/launch"] = kernel_us(
            lambda: call(x_pad, seed, tgt, win, inv_env, scalar, cfg, 50))
        raw = getattr(mod, it)
        res[f"{name} raw us"] = event_ms(lambda: raw(x_seq, s_seq, t_seq, win, scalar, cfg), 20) \
            * 1000
        res[f"{name} raw device us"] = kernel_us(lambda: raw(x_seq, s_seq, t_seq, win, scalar,
                                                             cfg))
        print(f"  {name}: {res[f'{name} us/iter']:.2f} us/iter marginal, "
              f"{res[f'{name} call us/iter']:.2f} per iteration of one call, device per launch "
              f"{res[f'{name} device us/launch']}; raw launch at {SEQ_FRAMES} frames "
              f"{res[f'{name} raw us']:.2f} us, device {res[f'{name} raw device us']}",
              flush=True)
    frames = torch.from_numpy(make_speech_like(431 * N_FFT, seed=3).astype(np.float32)) \
        .reshape(431, N_FFT).to(dev)
    res["fft us"] = graph_us(lambda: fft.ifft(fft.fft(frames), N_FFT))
    res["torch.fft us"] = graph_us(lambda: fft.ifft_reference(fft.fft_reference(frames), N_FFT))
    print(f"  B fwd+inv of 431 x {N_FFT} (CUDA graph): {res['fft us']:.2f} us, torch.fft "
          f"{res['torch.fft us']:.2f} us", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"root": args.root, "device": smi, **res}))


if __name__ == "__main__":
    main()
