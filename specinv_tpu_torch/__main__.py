"""Demo: invert a magnitude spectrogram with one of the four algorithms.

Counterpart of the JAX package's ``main.py``, on the port: it synthesizes a
test signal (or reads ``--input``), builds its magnitude spectrogram (hann
window, hop ``n_fft // 4``), inverts it with the chosen algorithm, prints the
spectral convergence of the result and optionally writes it (``--output``,
through ``specinv_tpu_torch.io``) and a figure (``--plot``, which needs
matplotlib).

Usage:
    python -m specinv_tpu_torch [griffin_lim|rtisi_la|admm|l_bfgs]
        [--n-fft 1024] [--max-iter 100] [--plot out.png]
        [--input in.wav] [--output recon.wav] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import sys
import time

import numpy as np


def make_demo_signal(sr=22050, seconds=4.0):
    """A few seconds of synthetic 'music': chirping partials + vibrato."""
    t = np.linspace(0, seconds, int(sr * seconds), dtype=np.float32)
    f0 = 220 * 2 ** (t / 4)  # rising octave sweep
    sig = np.zeros_like(t)
    for k, amp in ((1, 1.0), (2, 0.5), (3, 0.33), (4, 0.25)):
        sig += amp * np.sin(2 * np.pi * k * np.cumsum(f0) / sr + 0.1 * np.sin(2 * np.pi * 5 * t))
    sig *= np.exp(-0.2 * t)
    return (sig / np.abs(sig).max()).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m specinv_tpu_torch")
    ap.add_argument("algorithm", nargs="?", default="griffin_lim",
                    choices=["griffin_lim", "rtisi_la", "admm", "l_bfgs"])
    ap.add_argument("--n-fft", type=int, default=1024)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--plot", type=str, default=None, help="save a figure here")
    ap.add_argument("--input", type=str, default=None,
                    help="invert this WAV file instead of the synthetic demo signal")
    ap.add_argument("--output", type=str, default=None,
                    help="write the reconstruction to this WAV file")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where to run: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.plot:
        try:
            import matplotlib
        except ImportError:
            ap.error("--plot needs matplotlib, which is not installed")
        matplotlib.use("Agg")

    import torch

    import specinv_tpu_torch as st
    from specinv_tpu_torch.io import read_wav, write_wav
    from specinv_tpu_torch.ops.mel import log_mel_transform

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card: pass --device cpu to run on the CPU")

    if args.input:
        x, sr = read_wav(args.input)
        if x.ndim > 1:
            x = x.mean(axis=0)  # downmix to mono
        x = np.ascontiguousarray(x, np.float32)
    else:
        sr = 22050
        x = make_demo_signal(sr)
    window = np.hanning(args.n_fft + 1)[:-1].astype(np.float32)
    win = torch.from_numpy(window).to(device)
    xt = torch.from_numpy(x).to(device)

    def magnitude(sig):
        return st.stft(sig, args.n_fft, window=win).abs()  # (F, T)

    mag = magnitude(xt)

    t0 = time.time()
    if args.algorithm == "griffin_lim":
        y = st.griffin_lim(mag, max_iter=args.max_iter, verbose=False, window=win)
    elif args.algorithm == "rtisi_la":
        y = st.RTISI_LA(mag, look_ahead=3, max_iter=25, verbose=False, window=win)
    elif args.algorithm == "admm":
        y = st.ADMM(mag, max_iter=args.max_iter, verbose=False, window=win)
    else:
        fn = log_mel_transform(n_fft=args.n_fft, n_mels=128, sample_rate=sr, window=window)
        mel = fn(xt)
        y = st.L_BFGS(mel, fn, samples=(x.size,), outer_max_iter=args.max_iter // 10,
                      max_iter=10, line_search_fn="strong_wolfe", verbose=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    sc_db = float(st.sc(magnitude(y), mag))
    y = y.cpu().numpy()
    print(f"{args.algorithm}: {dt:.2f}s, output {y.shape}, spectral convergence {sc_db:.2f} dB")

    if args.output:
        write_wav(args.output, y, sr)
        print(f"wrote {args.output}")

    if args.plot:
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
        for ax, sig, title in ((axes[0], x, "original"), (axes[1], y, "reconstruction")):
            s = magnitude(torch.from_numpy(np.asarray(sig, np.float32)).to(device)).cpu().numpy()
            ax.imshow(20 * np.log10(s + 1e-6), origin="lower", aspect="auto",
                      extent=[0, len(sig) / sr, 0, sr / 2000])
            ax.set_ylabel(f"{title}\nkHz")
        axes[1].set_xlabel("seconds")
        fig.suptitle(f"{args.algorithm}: SC {sc_db:.1f} dB")
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"wrote {args.plot}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
