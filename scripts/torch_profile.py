#!/usr/bin/env python3
"""Where the time goes in specinv_tpu_torch's main paths on one CUDA card,
and how far float32 RTISI-LA runs lie from a float64 one.

Run from the root of a checkout: ``python3 scripts/torch_profile.py
[--only config4]`` (one card, nvcc; about three minutes on an H100;
``--only config4`` profiles config 4 and ``mel_to_audio`` alone).  It fails
without a card.

1. ``torch.profiler`` over one call of each path, after a warm-up call:
   griffin_lim and ADMM (BASELINE configs 1 and 2: a 10 s speech-like clip,
   n_fft 2048, hop 512, 50 iterations, tol 0) through the whole-run kernel,
   the direct-DFT kernel ('dft', precision 'high') and the ``torch.fft``
   path; griffin_lim at n_fft 400 / hop 160 (ROADMAP cell C7) through
   'dft' and ``torch.fft``; and RTISI_LA (config 3: look-ahead 3, 25
   refinements, a 2 s clip at batch 1 and 16) through the kernel and the
   ``torch.fft`` path; griffin_lim_seq and admm_seq (rho 0.1) on a
   10-minute clip at world size 1 (the 1x1 mesh), 20 iterations, through
   the raw kernel dispatch and ``torch.fft``; BASELINE config 4 (L_BFGS
   on the 10 s clip's 128-band log-mel, 10 x 20 iterations, history 100:
   strong Wolfe with a float32 and a bf16 history, and the fixed step) and
   ``mel_to_audio`` (128 mels, NNLS 200, 100 Griffin-Lim iterations).  Per
   unit of work (an iteration, an output-frame step, an outer step or a
   call) it prints the device kernels and the
   device time, then the call's wall time, the device's idle share of it
   (1 - the union of kernel intervals over the wall time) and the top
   kernels by device time.
2. RTISI_LA at config 3 on 16 speech-like 10 s clips through the kernel
   path, the ``torch.fft`` path in float32 and the ``torch.fft`` path in
   float64: the final SC (dB) of each clip, each float32 path's largest
   distance from float64 and the worst SC.  chip_smoke.py's RTISI SC band
   and ceiling rest on these.
"""
from __future__ import annotations

import collections
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
N_FFT, HOP, SR = 2048, 512, 22050


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def short(name: str) -> str:
    """A kernel's name without its return type and the port's namespace."""
    return name.replace("void ", "").replace("specinv::(anonymous namespace)::", "")


def profile_call(label: str, fn, units: int, unit: str) -> None:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    device_us = sum(by_name.values())
    idle = 1.0 - busy_us((e.time_range.start, e.time_range.end) for e in kernels) / wall_us
    top = ", ".join(f"{short(name)[:40]} {t / units:.2f} us"
                    for name, t in by_name.most_common(3))
    print(f"  {label}: {len(kernels) / units:.1f} device kernels / {unit}, device time "
          f"{device_us / units:.2f} us / {unit}; call {wall_us / 1e3:.1f} ms, idle share "
          f"{100 * idle:.1f} %; top: {top}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import specinv_tpu_torch as st
    from specinv_tpu_torch.utils.corpus import make_speech_like

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__}",
          flush=True)
    dev = torch.device("cuda", 0)
    window = torch.hann_window(N_FFT, device=dev)
    kw = dict(hop_length=HOP, window=window, verbose=False)

    def mags(batch, seconds):
        clips = np.stack([make_speech_like(int(SR * seconds), seed=s) for s in range(batch)])
        x = torch.from_numpy(clips.astype(np.float32)).to(dev)
        return st.stft(x, N_FFT, hop_length=HOP, window=window).abs()

    print("[1] torch.profiler, one call after a warm-up", flush=True)
    mag10 = mags(1, 10.0)[0]
    clip10 = torch.from_numpy(make_speech_like(int(SR * 10.0), seed=0).astype(np.float32)).to(dev)
    logmel = st.log_mel_transform(n_fft=N_FFT, n_mels=128, sample_rate=SR, hop_length=HOP,
                                  window=window)
    target = logmel(clip10)
    for name, extra in (("strong Wolfe", dict(line_search_fn="strong_wolfe")),
                        ("strong Wolfe, bf16 history",
                         dict(line_search_fn="strong_wolfe", history_dtype="bfloat16")),
                        ("fixed step", {})):
        profile_call(f"L_BFGS {name}, config 4",
                     lambda: st.L_BFGS(target, logmel, samples=(clip10.numel(),),
                                       outer_max_iter=10, max_iter=20, history_size=100, tol=0.0,
                                       verbose=False, **extra), 10, "outer step")
    mel = torch.clamp(torch.exp(target) - 1e-6, min=0.0)
    profile_call("mel_to_audio, config 1's geometry, 128 mels",
                 lambda: st.mel_to_audio(mel, N_FFT, SR, hop_length=HOP, window=window,
                                         max_iter=100, tol=0.0), 1, "call")
    if "--only" in sys.argv:
        return
    for name, fn in (("griffin_lim", st.griffin_lim),
                     ("ADMM", lambda m, **k: st.ADMM(m, rho=0.1, **k))):
        for backend in ("kernel", "dft", "fft"):
            profile_call(f"{name} {backend}, config {1 if name == 'griffin_lim' else 2}",
                         lambda: fn(mag10, max_iter=50, tol=0.0, backend=backend, **kw), 50,
                         "iteration")
    win400 = torch.hann_window(400, device=dev)
    kw400 = dict(hop_length=160, window=win400, verbose=False)
    mag400 = st.stft(torch.from_numpy(make_speech_like(int(SR * 10.0), seed=0).astype(np.float32))
                     .to(dev), 400, hop_length=160, window=win400).abs()
    for backend in ("dft", "fft"):
        profile_call(f"griffin_lim {backend}, n_fft 400 / hop 160",
                     lambda: st.griffin_lim(mag400, max_iter=50, tol=0.0, backend=backend,
                                            **kw400), 50, "iteration")
    rtisi_kw = dict(look_ahead=3, max_iter=25, **kw)
    for batch in (1, 16):
        mag2 = mags(batch, 2.0)
        steps = mag2.shape[-1] + 3
        for backend in ("kernel", "fft"):
            profile_call(f"RTISI_LA {backend}, config 3, B={batch}",
                         lambda: st.RTISI_LA(mag2, backend=backend, **rtisi_kw), steps,
                         "frame step")

    from specinv_tpu_torch.parallel import admm_seq, griffin_lim_seq, make_mesh

    mesh = make_mesh()
    seq_window = torch.hann_window(N_FFT).to(dev)
    clip = torch.from_numpy(make_speech_like(SR * 600, seed=0).astype(np.float32)).to(dev)
    mag600 = st.stft(clip, N_FFT, hop_length=HOP, window=seq_window).abs()
    for name, fn in (("griffin_lim_seq", griffin_lim_seq),
                     ("admm_seq", lambda m, mesh, **k: admm_seq(m, mesh, rho=0.1, **k))):
        for backend in ("kernel", "fft"):
            profile_call(f"{name} {backend}, 10-minute clip, world size 1",
                         lambda: fn(mag600, mesh, max_iter=20, backend=backend, hop_length=HOP,
                                    window=seq_window), 20, "iteration")

    print("[2] RTISI_LA SC at config 3, 16 clips of 10 s: float32 paths against float64",
          flush=True)
    mag16 = mags(16, 10.0)
    runs = {"kernel": (mag16, window, "kernel"), "fft32": (mag16, window, "fft"),
            "fft64": (mag16.double(), window.double(), "fft")}
    sc = {}
    for name, (m, w, backend) in runs.items():
        y = st.RTISI_LA(m, backend=backend, look_ahead=3, max_iter=25, hop_length=HOP, window=w,
                        verbose=False)
        sc[name] = np.array([float(st.sc(st.stft(y[b], N_FFT, hop_length=HOP, window=w).abs(),
                                         m[b])) for b in range(16)])
        print(f"  {name}: SC {np.array2string(sc[name], precision=4)} dB", flush=True)
    for name in ("kernel", "fft32"):
        print(f"  {name}: max |SC - SC(fft64)| {np.abs(sc[name] - sc['fft64']).max():.4f} dB, "
              f"worst SC {sc[name].max():.4f} dB", flush=True)
    print(f"  fft64: worst SC {sc['fft64'].max():.4f} dB; on {smi}", flush=True)


if __name__ == "__main__":
    main()
