#!/usr/bin/env python3
"""Read the 1000-iteration quality of the kernel paths on one CUDA card: the
final spectral convergence (SC) of ``griffin_lim`` (BASELINE config 1) and
``ADMM`` (config 2, rho 0.1) through ``backend='kernel'`` (the whole-run
kernels) and ``backend='dft'`` (the direct-DFT kernels, precision 'high')
against the port's float64 ``torch.fft`` path from the same magnitude.

Run from the root of a checkout: ``python3 scripts/torch_sc_1000.py [--root
TREE]``, where ``TREE`` holds the ``specinv_tpu_torch`` package to read
(default: this checkout), so that an unpacked older commit is read by the
same script.  It fails without a card.

A 10 s speech-like clip (``utils/corpus`` seed 0, n_fft 2048, hop 512,
hann), 1000 iterations, tol 0.  Each path starts from its own SPSI seed
(the float64 path from a float64 one), as ``chip_smoke.py`` phase 4 does.
The last lines are the card's name and power limit and one JSON object with
every SC and each path's gap from float64 in dB.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N_FFT, HOP, N_SAMPLES, ITERS, RHO = 2048, 512, 220500, 1000, 0.1


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="tree that holds the specinv_tpu_torch package")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_sc_1000: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import specinv_tpu_torch as st
    from specinv_tpu_torch.utils.corpus import make_speech_like

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    clip = torch.from_numpy(make_speech_like(N_SAMPLES, seed=0).astype(np.float32)).to(dev)
    window = torch.hann_window(N_FFT, device=dev)
    mag = st.stft(clip, N_FFT, hop_length=HOP, window=window).abs()

    def sc_db(y, spec, w):
        return float(st.sc(st.stft(y, N_FFT, hop_length=HOP, window=w).abs(), spec))

    out = {"root": str(Path(args.root).resolve()), "iterations": ITERS}
    for name, fn in (("griffin_lim", st.griffin_lim),
                     ("ADMM", lambda spec, **k: st.ADMM(spec, rho=RHO, **k))):
        kw = dict(max_iter=ITERS, tol=0.0, hop_length=HOP, verbose=False)
        sc = {
            "kernel": sc_db(fn(mag, backend="kernel", window=window, **kw), mag, window),
            "dft": sc_db(fn(mag, backend="dft", precision="high", window=window, **kw), mag,
                         window),
            "fft": sc_db(fn(mag, backend="fft", window=window, **kw), mag, window),
            "fft float64": sc_db(fn(mag.double(), backend="fft", window=window.double(), **kw),
                                 mag.double(), window.double()),
        }
        gaps = {path: abs(v - sc["fft float64"]) for path, v in sc.items() if path != "fft float64"}
        out[name] = {"sc_db": sc, "gap_db": gaps}
        print(f"{name}, {ITERS} iterations: SC kernel {sc['kernel']:.6f} dB, dft "
              f"{sc['dft']:.6f}, fft float32 {sc['fft']:.6f}, fft float64 "
              f"{sc['fft float64']:.6f}; gap from float64: kernel {gaps['kernel']:.6f} dB, dft "
              f"{gaps['dft']:.6f} dB, fft float32 {gaps['fft']:.6f} dB", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
