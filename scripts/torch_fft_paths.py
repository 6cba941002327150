#!/usr/bin/env python3
"""Time the ``torch.fft`` paths of specinv_tpu_torch on one CUDA card, to
compare two trees of the package in one call.

Run from the root of a checkout: ``python3 scripts/torch_fft_paths.py
[--root TREE]``, where ``TREE`` holds the ``specinv_tpu_torch`` package to
time (default: this checkout), so that an unpacked older commit can be
timed by the same script, e.g. parent, change, change, parent in one call.
It fails without a card.

On a 10 s speech-like clip (n_fft 2048, hop 512, hann): ``griffin_lim`` and
``ADMM`` (rho 0.1) with ``backend='fft'``, and ``griffin_lim`` at n_fft 400
/ hop 160, marginal microseconds per iteration from CUDA events ((t(200) -
t(100)) / 100, median of 3); ``RTISI_LA`` (look-ahead 3, 25 refinements)
with ``backend='fft'`` at batch 1 and 16, microseconds per output-frame
step from a 2 s against a 1 s clip (median of 3); and, from
``torch.profiler`` over a 50-iteration ``griffin_lim`` / ``ADMM`` call,
device operations and device time per iteration.  The last lines are the
card's name and power limit and one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N_FFT, HOP, N_SAMPLES = 2048, 512, 220500


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def marginal_us(fn) -> float:
    """(t(200) - t(100)) / 100 in microseconds, medians of 3, after a warm-up."""
    fn(100)
    t = {100: [], 200: []}
    for _ in range(3):
        for n in (100, 200):
            t[n].append(event_ms(lambda: fn(n)))
    return (float(np.median(t[200])) - float(np.median(t[100]))) / 100 * 1000


def device_per_iter(fn, iters: int = 50):
    """(device operations, device microseconds) per iteration of ``fn(iters)``."""
    from torch.profiler import ProfilerActivity, profile

    fn(iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(iters)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events) / iters, sum(e.time_range.elapsed_us() for e in events) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fft_paths: torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import specinv_tpu_torch as st
    from specinv_tpu_torch.utils.corpus import make_speech_like

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"package {st.__file__}", flush=True)
    window = torch.hann_window(N_FFT).to(dev)
    clips = torch.from_numpy(np.stack([make_speech_like(N_SAMPLES, seed=s)
                                       for s in range(16)]).astype(np.float32)).to(dev)
    mag = st.stft(clips[0], N_FFT, hop_length=HOP, window=window).abs()
    kw = dict(hop_length=HOP, window=window, verbose=False, backend="fft")
    c7_window = torch.hann_window(400).to(dev)
    c7_mag = st.stft(clips[0], 400, hop_length=160, window=c7_window).abs()
    res = {}
    calls = {
        "griffin_lim": lambda n: st.griffin_lim(mag, max_iter=n, tol=0.0, **kw),
        "ADMM": lambda n: st.ADMM(mag, max_iter=n, tol=0.0, rho=0.1, **kw),
        "griffin_lim 400/160": lambda n: st.griffin_lim(
            c7_mag, max_iter=n, tol=0.0, hop_length=160, window=c7_window, verbose=False,
            backend="fft"),
    }
    for name, fn in calls.items():
        res[f"{name} us/iter"] = marginal_us(fn)
        print(f"  {name} fft path: {res[f'{name} us/iter']:.2f} us/iter", flush=True)
    for name in ("griffin_lim", "ADMM"):
        ops, us = device_per_iter(calls[name])
        res[f"{name} device ops/iter"], res[f"{name} device us/iter"] = ops, us
        print(f"  {name} fft path: {ops:.1f} device ops, {us:.2f} device us per iteration",
              flush=True)
    rkw = dict(look_ahead=3, max_iter=25, hop_length=HOP, window=window, verbose=False,
               backend="fft")
    for batch in (1, 16):
        mags = [st.stft(clips[:batch, :n], N_FFT, hop_length=HOP, window=window).abs()
                for n in (2 * 22050, 22050)]
        steps = [m.shape[-1] + 3 for m in mags]
        st.RTISI_LA(mags[1], **rkw)
        t = {0: [], 1: []}
        for _ in range(3):
            for i, m in enumerate(mags):
                t[i].append(event_ms(lambda: st.RTISI_LA(m, **rkw)))
        us = (float(np.median(t[0])) - float(np.median(t[1]))) / (steps[0] - steps[1]) * 1000
        res[f"RTISI_LA B={batch} us/step"] = us
        print(f"  RTISI_LA fft path, B={batch}: {us:.2f} us per output-frame step", flush=True)
    print(smi)
    print(json.dumps({"root": args.root, "device": smi, **res}))


if __name__ == "__main__":
    main()
