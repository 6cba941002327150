#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: Griffin-Lim
(config 1) and ADMM (config 2).

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and no network, and fails (nonzero exit, no result line)
without them.  Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the path from ``specinv_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card: the
   device FFT (``csrc/fft.cuh``), the whole-run Griffin-Lim kernel
   (``csrc/gl_fullrun.cu``) and the whole-run ADMM kernel
   (``csrc/admm_fullrun.cu``) at the main paths' shapes (n_fft 2048, hop
   512, 431 frames; 1 and 5 iterations) and, at a batch of 2 small clips, in
   every pad mode, with ``center=False``, with hops that do not divide n_fft,
   ``normalized=True`` and ``onesided=False``;
4. the main paths, each on a 10 s speech-like clip (22.05 kHz, hann, n_fft
   2048, hop 512), 100 iterations, tol 0, with the launch counts set to 0
   just before and read just after, the final spectral convergence held
   against the ``torch.fft`` path, then the same call with early stopping:
   ``specinv_tpu_torch.griffin_lim``, then ``specinv_tpu_torch.ADMM``
   (rho 0.1);
5. marginal microseconds per iteration of the kernel and ``torch.fft``
   paths of both, from CUDA events, by differencing 200 and 100
   iterations, and each whole-run kernel against its plain version.

The line before the last is ``nvidia-smi``'s name and power limit, the one
before it a JSON object with each kernel's launches, error and times; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

N_FFT, HOP, N_SAMPLES = 2048, 512, 220500  # 10 s at 22.05 kHz
MAIN_ITERS = 100

# Kernel against plain version, float32 on the card.  Relative to the
# largest value of the plain output: x at 5e-5 (the JAX package's HIGHEST
# band), the state and magnitude planes at 1e-4 (float32 rounding of two
# FFT orders, about 2.5e-5 after 5 iterations in the CPU tests), the eval
# sums at 1e-4, the stand-alone FFT at 1e-5.
X_LIMIT, PLANE_LIMIT, SUM_LIMIT, FFT_LIMIT = 5e-5, 1e-4, 1e-4, 1e-5
# Final SC (dB) of the kernel path against the torch.fft path after 100
# iterations: the same algorithm in float32 through two FFT implementations
# (they agreed within 1e-4 dB on an H100).
SC_BAND_DB = 0.01
# Quality floor of the main path (the repo's check: SC well below -15 dB).
SC_CEILING_DB = -15.0
# ADMM kernel against its plain version, float32, relative to the max.
# ADMM drifts about 10x more than Griffin-Lim because its dual integrates
# rounding, most at 512/160.  A float64 run of the plain version on an H100
# is the anchor: there the kernel lies at most x 3.6e-4, Y 7.8e-4, |R|
# 1.3e-4 from it and the plain float32 version (cuFFT) x 4.6e-4, Y 1.5e-3,
# |R| 3.1e-4, eval sums 1.8e-6 / 3.6e-6 (relative; config 2 at 1 and 5
# iterations and the small set).  Each limit is twice the sum of the two
# sides, rounded up to one digit.  A wrong sign in the update moves x by
# 0.94 of its max (tests/test_torch_admm_fullrun.py).
ADMM_X_LIMIT, ADMM_PLANE_LIMIT, ADMM_SUM_LIMIT = 2e-3, 5e-3, 2e-5
# Final SC (dB) of the ADMM kernel path against the torch.fft path after 100
# iterations.  The kernel path is the DR one-variable form, the fft path the
# literal (X, Y, U, x) chain; over 100 iterations the chain amplifies any
# rounding difference into a different trajectory of about the same
# quality.  On the CPU the two paths ended 0.198 dB apart in float32 and
# 0.067 dB apart in float64; the band is three times the float32 gap.
ADMM_SC_BAND_DB = 0.6
# ADMM quality ceiling: the port's float64 CPU run of the same call ends at
# -27.82 dB; float32 runs of the two paths ended 1.4-1.6 dB from it on the
# CPU, so the ceiling allows 2 dB.
ADMM_SC_CEILING_DB = -25.8
ADMM_RHO = 0.1


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def check(name: str, err: float, limit: float) -> None:
    print(f"  {name}: max rel err {err:.3e} (limit {limit:.0e})", flush=True)
    if not err <= limit:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {limit:.0e}")


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_state(n_fft, hop, n_samples, batch, dev, **stft_kwargs):
    """A real starting state of a whole-run kernel: the speech clip's
    magnitude, the SPSI seed (Griffin-Lim's momentum, ADMM's Y0) and
    ``istft(seed)`` in padded coordinates."""
    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.models import _kernel_driver as kd
    from specinv_tpu_torch.models.phase_init import phase_init_tm
    from specinv_tpu_torch.ops import stft as stft_ops
    from specinv_tpu_torch.ops.framing import pad_center
    from specinv_tpu_torch.utils.corpus import make_speech_like

    win_np = torch.hann_window(n_fft).numpy()
    bins = n_fft if stft_kwargs.get("onesided") is False else n_fft // 2 + 1
    cfg, w = canonicalize(bins, np.float32, window=win_np, hop_length=hop, **stft_kwargs)
    clips = np.stack([make_speech_like(n_samples, seed=s) for s in range(batch)])
    x = torch.from_numpy(clips.astype(np.float32)).to(dev)
    win = torch.from_numpy(w).to(dev)
    mag = stft_ops.stft(x, cfg, win).abs().contiguous()
    seed = phase_init_tm(mag, cfg).to(torch.complex64)
    T = mag.shape[-2]
    geo = kd.make_geometry(cfg, T)
    x_pad = pad_center(stft_ops.istft(seed, cfg, win), cfg).contiguous()
    return cfg, (x_pad, seed, mag, win, kd.make_inv_env(cfg, win, T, geo))


def check_kernel(label, mod, run, scalar, cfg, state, n_iters, limits):
    """Kernel ``mod.<run>`` against ``mod.<run>_reference``; returns the max
    abs error of x."""
    x_lim, plane_lim, sum_lim = limits
    flags = dict(emit_state=True, with_mag=True, with_loss=True)
    ours = getattr(mod, run)(*state, scalar, cfg, n_iters, **flags)
    ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, n_iters, **flags)
    torch.cuda.synchronize()
    x, st, mag, stats = ours
    rx, rst, rmag, rstats = ref
    check(f"{label} x", rel_err(x, rx), x_lim)
    check(f"{label} state", rel_err(torch.view_as_real(st), torch.view_as_real(rst)), plane_lim)
    check(f"{label} |S|", rel_err(mag, rmag), plane_lim)
    check(f"{label} eval sums", float(((stats - rstats).abs() / rstats.abs()).max()), sum_lim)
    return abs_err(x, rx)


def marginal_us(fn):
    """Marginal microseconds per iteration of ``fn(n_iters)``: CUDA-event
    medians of 3 runs at 200 and at 100 iterations, differenced."""
    t = {n: [] for n in (100, 200)}
    for _ in range(3):
        for n in (100, 200):
            t[n].append(time_ms(lambda: fn(n), 2))
    return (float(np.median(t[200])) - float(np.median(t[100]))) / 100 * 1000


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not (ROOT / "specinv_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import specinv_tpu_torch as st
    from specinv_tpu_torch.ops.cuda import _build, admm_fullrun, fft, gl_fullrun
    from specinv_tpu_torch.utils.corpus import make_speech_like

    counted = (gl_fullrun, admm_fullrun, fft)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    print(f"[2] built {[p.name for p in _build._sources()]} with nvcc in "
          f"{_build.last_build_seconds:.2f} s (build + load {time.perf_counter() - t0:.2f} s)",
          flush=True)

    print("[3] kernels against their plain versions (float32, on the card)", flush=True)
    frames = torch.from_numpy(
        make_speech_like(431 * N_FFT, seed=3).astype(np.float32)).reshape(431, N_FFT).to(dev)
    spec_k, spec_r = fft.fft(frames), fft.fft_reference(frames)
    back_k, back_r = fft.ifft(spec_r.contiguous(), N_FFT), fft.ifft_reference(spec_r, N_FFT)
    torch.cuda.synchronize()
    check("fft.cuh forward (431 x 2048)", rel_err(spec_k, spec_r), FFT_LIMIT)
    check("fft.cuh inverse (431 x 2048)", rel_err(back_k, back_r), FFT_LIMIT)
    fft_err = max(abs_err(spec_k, spec_r), abs_err(back_k, back_r))

    lr = 0.99 / 1.99
    gl_limits = (X_LIMIT, PLANE_LIMIT, SUM_LIMIT)
    admm_limits = (ADMM_X_LIMIT, ADMM_PLANE_LIMIT, ADMM_SUM_LIMIT)
    cfg1, state1 = kernel_state(N_FFT, HOP, N_SAMPLES, 1, dev)
    if state1[2].shape != (1, 431, 1025):
        raise AssertionError(f"config 1 target shape {tuple(state1[2].shape)}")
    gl_err = admm_err = 0.0
    for n_iters in (1, 5):
        gl_err = max(gl_err, check_kernel(f"gl config 1, {n_iters} it", gl_fullrun,
                                          "fused_gl_run", lr, cfg1, state1, n_iters, gl_limits))
    for n_iters in (1, 5):
        admm_err = max(admm_err, check_kernel(
            f"admm config 2, {n_iters} it", admm_fullrun, "fused_admm_run", ADMM_RHO, cfg1,
            state1, n_iters, admm_limits))
    small = [(512, 128, dict(pad_mode=m)) for m in ("reflect", "constant", "replicate", "circular")]
    small += [(512, 128, dict(center=False)), (512, 160, {}),
              (512, 128, dict(normalized=True)), (256, 64, dict(onesided=False))]
    for n_fft, hop, extra in small + [(512, 384, {})]:
        cfg, state = kernel_state(n_fft, hop, 7800, 2, dev, **extra)
        check_kernel(f"gl {n_fft}/{hop} {extra or 'defaults'}, 5 it", gl_fullrun,
                     "fused_gl_run", lr, cfg, state, 5, gl_limits)
    for n_fft, hop, extra in small:
        cfg, state = kernel_state(n_fft, hop, 7800, 2, dev, **extra)
        check_kernel(f"admm {n_fft}/{hop} {extra or 'defaults'}, 5 it", admm_fullrun,
                     "fused_admm_run", ADMM_RHO, cfg, state, 5, admm_limits)

    clip = torch.from_numpy(make_speech_like(N_SAMPLES, seed=0).astype(np.float32)).to(dev)
    window = torch.hann_window(N_FFT, device=dev)
    mag = st.stft(clip, N_FFT, hop_length=HOP, window=window).abs()
    if mag.shape != (N_FFT // 2 + 1, 431):
        raise AssertionError(f"main-path spectrogram shape {tuple(mag.shape)}")
    kw = dict(hop_length=HOP, window=window, verbose=False)
    expected_len = (431 - 1) * HOP

    def sc_db(y):
        return float(st.sc(st.stft(y, N_FFT, hop_length=HOP, window=window).abs(), mag))

    def drive(name, fn, mod, band, ceiling):
        """One main path: 100 iterations through the kernel (launch count
        read), SC against the torch.fft path, then with early stopping."""
        for counted_mod in counted:
            counted_mod.launches = 0
        y = fn(mag, max_iter=MAIN_ITERS, tol=0.0, **kw)
        torch.cuda.synchronize()
        launches = mod.launches
        if y.shape != (expected_len,) or y.device != clip.device or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"bad output: {tuple(y.shape)} on {y.device}")
        if launches != MAIN_ITERS:
            raise AssertionError(f"kernel launched {launches} times, expected {MAIN_ITERS}")
        y_fft = fn(mag, max_iter=MAIN_ITERS, tol=0.0, backend="fft", **kw)
        sc_k, sc_f = sc_db(y), sc_db(y_fft)
        print(f"  kernel launches {launches} (expected {MAIN_ITERS}); output {tuple(y.shape)} finite",
              flush=True)
        print(f"  SC after {MAIN_ITERS} it: kernel {sc_k:.4f} dB, fft {sc_f:.4f} dB, "
              f"diff {abs(sc_k - sc_f):.4f} dB (band {band})", flush=True)
        if not abs(sc_k - sc_f) <= band:
            raise AssertionError(f"{name}: kernel and fft paths disagree on SC")
        if not sc_k < ceiling:
            raise AssertionError(f"{name}: SC {sc_k:.2f} dB is not below {ceiling} dB")
        before = mod.launches
        y_es = fn(mag, max_iter=MAIN_ITERS, tol=1e-6, eva_iter=10, **kw)
        es_launches = mod.launches - before
        print(f"  tol=1e-6, eva_iter=10: {es_launches} launches, SC {sc_db(y_es):.4f} dB", flush=True)
        if es_launches != MAIN_ITERS or not bool(torch.isfinite(y_es).all()):
            raise AssertionError(f"{name}: early-stopping run went wrong")
        return launches

    print("[4] main path: griffin_lim, 10 s clip, n_fft 2048, hop 512, 100 iterations", flush=True)
    gl_launches = drive("griffin_lim", st.griffin_lim, gl_fullrun, SC_BAND_DB, SC_CEILING_DB)

    def admm(spec, **k):
        return st.ADMM(spec, rho=ADMM_RHO, **k)

    print(f"[4] main path: ADMM, rho {ADMM_RHO}, 10 s clip, n_fft 2048, hop 512, 100 iterations",
          flush=True)
    admm_launches = drive("ADMM", admm, admm_fullrun, ADMM_SC_BAND_DB, ADMM_SC_CEILING_DB)

    print("[5] marginal time per iteration (CUDA events, 200 - 100 iterations)", flush=True)
    paths = (("griffin_lim", st.griffin_lim), ("ADMM", admm))
    us = {}
    for backend in ("fft", "kernel", "kernel", "fft"):  # both algorithms in each turn
        for name, fn in paths:
            us.setdefault((name, backend), []).append(marginal_us(
                lambda n: fn(mag, max_iter=n, tol=0.0, backend=backend, **kw)))
    for name, _ in paths:
        us_k, us_f = (float(np.mean(us[(name, b)])) for b in ("kernel", "fft"))
        print(f"  {name}: kernel path {us_k:.2f} us/iter ({1e6 / us_k:.1f} it/s), "
              f"fft path {us_f:.2f} us/iter ({1e6 / us_f:.1f} it/s) on {smi}", flush=True)

    x_pad, seed, tgt, win, inv_env = state1

    def per_iter_ms(fn, scalar):
        return time_ms(lambda: fn(x_pad, seed, tgt, win, inv_env, scalar, cfg1, 100), 3) / 100

    gl_ms = per_iter_ms(gl_fullrun.fused_gl_run, lr)
    gl_plain_ms = per_iter_ms(gl_fullrun.fused_gl_run_reference, lr)
    admm_ms = per_iter_ms(admm_fullrun.fused_admm_run, ADMM_RHO)
    admm_plain_ms = per_iter_ms(admm_fullrun.fused_admm_run_reference, ADMM_RHO)
    fft_ms = time_ms(lambda: fft.ifft(fft.fft(frames), N_FFT), 50)
    fft_plain_ms = time_ms(lambda: fft.ifft_reference(fft.fft_reference(frames), N_FFT), 50)
    print(f"  whole-run GL kernel {gl_ms * 1000:.2f} us/iter vs plain {gl_plain_ms * 1000:.2f}; "
          f"whole-run ADMM kernel {admm_ms * 1000:.2f} us/iter vs plain "
          f"{admm_plain_ms * 1000:.2f}; fft.cuh fwd+inv {fft_ms * 1000:.2f} us vs torch.fft "
          f"{fft_plain_ms * 1000:.2f} on {smi}", flush=True)

    kernels = [
        {"name": "gl_fullrun", "route": "cuda", "source": "specinv_tpu_torch/csrc/gl_fullrun.cu",
         "replaces": "specinv_tpu/ops/pallas/fullrun_lane.py:377 (algo='gl'); "
                     "specinv_tpu/ops/pallas/gl_fullrun4.py:223",
         "launches": gl_launches, "max_abs_err": gl_err, "ms": gl_ms, "plain_ms": gl_plain_ms},
        {"name": "admm_fullrun", "route": "cuda", "source": "specinv_tpu_torch/csrc/admm_fullrun.cu",
         "replaces": "specinv_tpu/ops/pallas/fullrun_lane.py:377 (algo='admm'); "
                     "specinv_tpu/ops/pallas/admm_fused4.py:275",
         "launches": admm_launches, "max_abs_err": admm_err, "ms": admm_ms,
         "plain_ms": admm_plain_ms},
        # fft.cuh runs inside the frame kernel of every gl_fullrun and
        # admm_fullrun launch
        {"name": "fft", "route": "cuda", "source": "specinv_tpu_torch/csrc/fft.cuh",
         "replaces": "specinv_tpu/ops/pallas/fft4.py:322",
         "launches": gl_launches + admm_launches, "max_abs_err": fft_err, "ms": fft_ms,
         "plain_ms": fft_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
