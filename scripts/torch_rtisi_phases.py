#!/usr/bin/env python3
"""Where one refinement of the RTISI-LA kernel (``csrc/rtisi_fused.cu``)
spends its time on one CUDA card, and how sensitive its check is.

Run from the root of a checkout: ``python3 scripts/torch_rtisi_phases.py
[1] [2] [3]`` (all three sections when none is named).

1. Phases: the kernel built with ``-DSPECINV_PHASE_MARKS`` (``clock64``
   marks on thread 0 of block 0 after each phase of a refinement: the
   cluster barrier, the step's committed tail and target rows, the gather,
   the forward FFT, the pair pass, the inverse FFT with the replica stores,
   the commit) beside the package's library, launched through the wrapper
   at BASELINE config 3, batch 1, from chip_smoke's check state at step
   100: microseconds per step (CUDA events over launches of 8 steps) and
   per refinement in each phase (the clock rate taken from the same
   launches).  The marks cost a few percent of a step.
2. The RTISI checks' sensitivity to their starting state.  (a) The
   kernel's two homes for the state, shared memory and device memory: at
   geometries where the state fits in shared memory, launches of 8 steps
   with the default plan against the same launches with the state forced
   into device memory, bit for bit.  (b) chip_smoke's RTISI checks (8
   single steps, each from the plain version's state, kernel against plain
   float32, both against float64), readings only, from the state the kernel
   under test reaches itself, as the checks started before they took
   ``chip_smoke_rtisi_states.npz``: which readings exceed their limits.
   (c) The same readings at 4096/1024 (hamming, asymmetric windows) and at
   config 3 with look-ahead 3, batch 2, from step 12, for clips of four
   seeds and from three states each: the kernel's, the plain float32
   version's and the float64 plain version's.  (d) At the step furthest
   from float64 (kernel or plain) in each check of (b) that exceeds a limit,
   and in (c): the float64 step from six copies of the state before it
   perturbed by about one float32 rounding (relative 2^-24 Gaussian noise),
   each against the unperturbed float64 step, beside the kernel from the
   same copies: how far float64 itself moves there.
3. One step at the shapes of ``tests/test_torch_cuda_kernels.py::
   test_rtisi_step_matches_plain_version`` (n_fft 16, 256, 4096 at hop
   n_fft / 16, look-ahead 0, 3 and -1, batch 1 and 3, 5 refinements from a
   state the plain version advanced 4 steps), the kernel and the plain
   float32 step each against a float64 plain step: the readings behind that
   test's limits.
"""
from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from specinv_tpu_torch.ops.cuda import _build, rtisi_fused  # noqa: E402
from specinv_tpu_torch.ops.cuda.fft import scales, twiddles  # noqa: E402

PHASES = ("cluster barrier", "tail + target rows (refinement 0)", "gather", "forward FFT",
          "pair pass", "inverse FFT + replica stores", "commit")
NAMES = ("committed", "keeped", "update", "pre")
LR = 0.99 / 1.99


def marked_library() -> ctypes.CDLL:
    """The kernel built with its phase marks, with the package's flags."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "librtisi_phases.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DSPECINV_PHASE_MARKS", "-I", str(_build.SRC_DIR),
           "-shared", "-o", str(lib_path), str(_build.SRC_DIR / "rtisi_fused.cu"),
           str(_build.SRC_DIR / "fft.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.specinv_rtisi_steps.argtypes = _build._SIGNATURES["specinv_rtisi_steps"]
    lib.specinv_rtisi_steps.restype = ctypes.c_int
    lib.specinv_error_string.argtypes = [ctypes.c_int]
    lib.specinv_error_string.restype = ctypes.c_char_p
    lib.specinv_phase_read.argtypes = [ctypes.c_void_p]
    lib.specinv_phase_read.restype = ctypes.c_int
    return lib


def phases(dev, reps: int = 5) -> None:
    """Section 1 of the module docstring."""
    cfg, la, target, windows, fresh = cs.rtisi_state(cs.N_FFT, cs.HOP, cs.N_SAMPLES, 1, dev)
    state = cs.frozen_state(cs.rtisi_check_states(dev), "cfg3_b1", fresh)
    print(f"[1] phases of one refinement at config 3, B=1 (plan "
          f"{rtisi_fused.plan(cs.N_FFT, la + 1)})", flush=True)
    lib = marked_library()
    steps = 8
    tgt = target[:, 100 : 100 + steps + la].contiguous()
    counts = (ctypes.c_ulonglong * 8)()

    def run():
        return rtisi_fused.fused_rtisi_steps(*state, tgt, windows, LR, cfg, cs.RTISI_ITERS)

    library = _build.library
    _build.library = lambda: lib  # the wrapper launches through the marked build
    try:
        run()
        torch.cuda.synchronize()
        lib.specinv_phase_read(counts)  # drop the warm-up's counts
        ms = cs.time_ms(run, reps)  # reps + 1 launches, one of them a warm-up
        lib.specinv_phase_read(counts)
    finally:
        _build.library = library
    cycles = list(counts)
    hz = sum(cycles) / ((reps + 1) * ms * 1e-3)
    refinements = (reps + 1) * steps * cs.RTISI_ITERS
    split = [cycles[i] / hz / refinements * 1e6 for i in range(len(PHASES))]
    print(f"  {ms * 1000 / steps:.2f} us per step, {sum(split):.3f} us per refinement "
          f"(clock {hz / 1e9:.3f} GHz): "
          + ", ".join(f"{p} {t:.3f}" for p, t in zip(PHASES, split)), flush=True)


def launch(state, tgt, windows, cfg, p):
    """One launch of ``specinv_rtisi_steps`` with the plan ``p``."""
    keep, upd, pre = (t.contiguous().clone() for t in state)
    tgt = tgt.contiguous()
    ws = [w.contiguous() for w in windows]
    B, R, n = upd.shape
    k = tgt.shape[-2] - R + 1
    dev = upd.device
    com = torch.empty((k, B, n), device=dev)
    scratch = torch.empty(max(1, B * p.scratch), device=dev)
    fscale, iscale = scales(n, cfg.normalized)
    tw = twiddles(n, dev, torch.complex128)
    code = _build.library().specinv_rtisi_steps(
        keep.data_ptr(), upd.data_ptr(), pre.data_ptr(), tgt.data_ptr(),
        *(w.data_ptr() for w in ws), tw.data_ptr(), com.data_ptr(), scratch.data_ptr(),
        B, k, R, keep.shape[1], n, cfg.hop_length, cs.RTISI_ITERS, p.cluster,
        p.frames_per_cta, p.group, int(p.resident), p.threads, p.smem, p.scratch, LR, fscale,
        iscale, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "specinv_rtisi_steps")
    torch.cuda.synchronize()
    return com, keep, upd, pre


def in_device_memory(n: int, R: int) -> rtisi_fused.Plan:
    """``rtisi_fused.plan(n, R)`` with the state kept in device memory."""
    p = rtisi_fused.plan(n, R)
    half = n // 2
    fixed, per_frame = 16 * half + 4 * n, 32 * (half + half // 8)
    group = min(p.frames_per_cta, (rtisi_fused.SHARED_BYTES - fixed) // per_frame)
    threads = min(rtisi_fused.MAX_THREADS, -(-max(32, group * n // 4) // 32) * 32)
    return p._replace(group=group, resident=False, threads=threads,
                      smem=fixed + group * per_frame,
                      scratch=-(-R * (3 * n + 3 * (half + 1)) // 2) * 2)


def err(a, b) -> float:
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    return float((a.double() - b.double()).abs().max() / max(float(b.abs().max()), 1e-30))


def narrow(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex64 if t.is_complex() else torch.float32).contiguous()


def step64(state, tgt, windows, cfg):
    """The float64 plain step (state and target widened)."""
    w64 = type(windows)(*(w.double() for w in windows))
    return rtisi_fused.fused_rtisi_steps_reference(*(cs.wide(t) for t in (*state, tgt)), w64, LR,
                                                   cfg, cs.RTISI_ITERS)


def advance(cfg, la, target, windows, state, steps, how="kernel", k=8):
    """``state`` after ``steps`` steps through the kernel, the plain float32
    version or the float64 one (returned in float32), ``k`` per launch."""
    for i0 in range(0, steps, k):
        tgt = target[:, i0 : i0 + min(k, steps - i0) + la].contiguous()
        if how == "kernel":
            _, *state = rtisi_fused.fused_rtisi_steps(*state, tgt, windows, LR, cfg,
                                                      cs.RTISI_ITERS)
        elif how == "plain float32":
            _, *state = rtisi_fused.fused_rtisi_steps_reference(*state, tgt, windows, LR, cfg,
                                                                cs.RTISI_ITERS)
        else:
            _, *state = step64(state, tgt, windows, cfg)
        state = tuple(narrow(t) for t in state)
    return tuple(state)


def readings(cfg, la, target, windows, state, i0, k=8):
    """``check_rtisi``'s 8 single steps from ``state``, readings only: per
    output the worst (kernel - plain, kernel - float64, plain - float64),
    and (reading, step, state before it) of the step whose update lies
    furthest from float64 on either side."""
    worst, far = {name: (0.0, 0.0, 0.0) for name in NAMES}, (0.0, None, None, None)
    for s in range(k):
        t1 = target[:, i0 + s : i0 + s + 1 + la].contiguous()
        ours = rtisi_fused.fused_rtisi_steps(*state, t1, windows, LR, cfg, cs.RTISI_ITERS)
        ref = rtisi_fused.fused_rtisi_steps_reference(*state, t1, windows, LR, cfg,
                                                      cs.RTISI_ITERS)
        anchor = step64(state, t1, windows, cfg)
        for name, a, b, c in zip(NAMES, ours, ref, anchor):
            if b.numel():
                worst[name] = tuple(max(x, y) for x, y in zip(
                    worst[name], (err(a, b), err(a, c), err(b, c))))
        e = max(err(ours[2], anchor[2]), err(ref[2], anchor[2])) if ref[2].numel() else 0.0
        if e > far[0]:
            far = (e, i0 + s, state, t1)
        state = tuple(t.contiguous() for t in ref[1:])
    return worst, far


def witness(label, cfg, windows, far) -> None:
    """Section 2d: the float64 step from ``far``'s state perturbed by about
    one float32 rounding, and the kernel from the same copies."""
    e, step, state, t1 = far
    print(f"  {label}, step {step} (update {e:.2e} from float64 on one side):", flush=True)
    anchor = step64(state, t1, windows, cfg)
    gen = torch.Generator(device=state[0].device)
    for seed in range(6):
        gen.manual_seed(seed)
        moved = []
        for t in map(cs.wide, state):
            noise = torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype)
            moved.append(t + t.abs() * 2.0 ** -24 * noise)
        f64 = step64(moved, t1, windows, cfg)
        ours = rtisi_fused.fused_rtisi_steps(*map(narrow, moved), t1, windows, LR, cfg,
                                             cs.RTISI_ITERS)
        print(f"    perturbation {seed}: float64 " + "; ".join(
            f"{name} {err(a, c):.2e}" for name, a, c in zip(NAMES, f64, anchor))
            + " | kernel " + "; ".join(
            f"{name} {err(a, c):.2e}" for name, a, c in zip(NAMES, ours, anchor)), flush=True)


def sensitivity(dev) -> None:
    """Section 2 of the module docstring."""
    print("[2a] state in shared memory against state in device memory, launches of 8 steps",
          flush=True)
    for n, hop, extra in ((2048, 512, dict(look_ahead=3, window="hann")),
                          (4096, 1024, dict(look_ahead=1, window="hamming", asym=True)),
                          (512, 128, dict(window="hamming")),
                          (256, 32, dict(look_ahead=7, window="hamming")),
                          (1024, 64, dict(window="hamming"))):
        cfg, la, tgt, win, state = cs.rtisi_state(n, hop, max(7800, 8 * n), 2, dev, **extra)
        ours, theirs = rtisi_fused.plan(n, la + 1), in_device_memory(n, la + 1)
        same = []
        for i0 in (0, 8, 16):
            t8 = tgt[:, i0 : i0 + 8 + la].contiguous()
            a, b = launch(state, t8, win, cfg, ours), launch(state, t8, win, cfg, theirs)
            same.append(all(torch.equal(x, y) for x, y in zip(a, b)))
            state = a[1:]
        print(f"  {n}/{hop} {extra}, R={la + 1}, resident {ours.resident}: steps 0-23 "
              f"{'bit for bit' if all(same) else f'DIFFER {same}'}", flush=True)

    print("[2b] chip_smoke's RTISI checks from the state the kernel under test reaches "
          "(readings only): worst kernel - plain (kernel / plain from float64); '>' marks a "
          "reading above its limit", flush=True)
    over = []
    cases = [(f"config 3, B={b}", (cs.N_FFT, cs.HOP, cs.N_SAMPLES, b), {}, 100,
              cs.RTISI_LIMITS[b]) for b in (1, 16)]
    cases += [(f"{n}/{hop} {extra}", (n, hop, max(7800, 8 * n), 2),
               {"window": "hamming", **extra}, 0 if hop == n else 12, cs.RTISI_SMALL_LIMITS)
              for n, hop, extra in cs.RTISI_SMALL]
    for label, shape, extra, i0, limits in cases:
        cfg, la, tgt, win, state = cs.rtisi_state(*shape, dev, **extra)
        worst, far = readings(cfg, la, tgt, win, advance(cfg, la, tgt, win, state, i0), i0)
        print(f"  {label}: " + "; ".join(
            f"{name} {e[0]:.2e}{'>' if e[0] > limits[name] else ''} ({e[1]:.2e} / {e[2]:.2e})"
            for name, e in worst.items()), flush=True)
        excess = max(e[0] / limits[name] for name, e in worst.items())
        if excess > 1:
            over.append((excess, label, cfg, win, far))

    print("[2c] the same 8 single steps from step 12, batch 2, clips of four seeds, from "
          "three states: worst update and pre, kernel / plain float32 from float64",
          flush=True)
    seeds_far = (0.0, None)
    for label, n, hop, extra in (("4096/1024 asym", 4096, 1024,
                                  dict(window="hamming", asym=True)),
                                 ("config 3, la 3", 2048, 512, dict(look_ahead=3))):
        for seed0 in (0, 10, 20, 30):
            cfg, la, tgt, win, fresh = cs.rtisi_state(n, hop, max(7800, 8 * n), 2, dev,
                                                      seed0=seed0, **extra)
            for how in ("kernel", "plain float32", "float64"):
                state = advance(cfg, la, tgt, win, fresh, 12, how)
                worst, far = readings(cfg, la, tgt, win, state, 12)
                print(f"  {label}, seed {seed0}, from the {how} state: " + "; ".join(
                    f"{name} {worst[name][1]:.2e} / {worst[name][2]:.2e}"
                    for name in ("update", "pre")), flush=True)
                if far[0] > seeds_far[0]:
                    seeds_far = (far[0], (f"{label}, seed {seed0}, the {how} state", cfg, win,
                                          far))

    print("[2d] the float64 step from the state before the step furthest from float64 in "
          "each failing check of [2b] and in [2c], perturbed by about one float32 rounding "
          "(six draws), and the kernel from the same copies, each against the unperturbed "
          "float64 step", flush=True)
    for _, label, cfg, win, far in sorted(over, key=lambda x: -x[0]):
        witness(label, cfg, win, far)
    label, cfg, win, far = seeds_far[1]
    witness(label, cfg, win, far)


def card_test_steps(dev) -> None:
    """Section 3 of the module docstring."""
    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.ops import stft as stft_ops
    from specinv_tpu_torch.utils.corpus import make_speech_like

    print("[3] one step at the card test's shapes, 5 refinements", flush=True)
    rt = importlib.import_module("specinv_tpu_torch.models.rtisi_la")
    iters = 5
    worst = {}
    for n in (16, 256, 4096):
        hop = n // 16
        win = np.hanning(n + 1)[:-1].astype(np.float32)
        cfg, w = canonicalize(n // 2 + 1, np.float32, window=win, hop_length=hop)
        window = torch.from_numpy(w).to(dev)
        windows = rt.rtisi_windows(window, cfg, False)
        w64 = type(windows)(*(x.double() for x in windows))
        for look_ahead in (0, 3, -1):
            for batch in (1, 3):
                clips = np.stack([make_speech_like(max(4000, 24 * hop + n), seed=s)
                                  for s in range(batch)]).astype(np.float32)
                mag = stft_ops.stft(torch.from_numpy(clips).to(dev), cfg, window).abs()
                nk = (n - 1) // hop
                la = nk if look_ahead < 0 else look_ahead
                target = torch.nn.functional.pad(mag, (0, 0, la, la)).contiguous()
                state = (torch.zeros(batch, nk, n, device=dev), rt._seed_update(target, la, cfg),
                         torch.zeros(batch, la + 1, n // 2 + 1, dtype=torch.complex64,
                                     device=dev))
                _, *state = rtisi_fused.fused_rtisi_steps_reference(
                    *state, target[:, : 4 + la], windows, LR, cfg, iters)
                tgt = target[:, 4 : 5 + la].contiguous()
                ours = rtisi_fused.fused_rtisi_steps(*state, tgt, windows, LR, cfg, iters)
                ref = rtisi_fused.fused_rtisi_steps_reference(*state, tgt, windows, LR, cfg, iters)
                anchor = rtisi_fused.fused_rtisi_steps_reference(
                    *(cs.wide(t) for t in (*state, tgt)), w64, LR, cfg, iters)
                for name, a, b, c in zip(NAMES, ours, ref, anchor):
                    if b.numel():
                        e = (err(a, c), err(b, c), err(a, b))
                        worst[name] = max(worst.get(name, (0.0, 0.0, 0.0)), e,
                                          key=lambda x: x[0] + x[1])
    print("  worst over the shapes (by the sum of the first two): " + "; ".join(
        f"{name} kernel / plain from float64 {e[0]:.2e} / {e[1]:.2e} (kernel-plain {e[2]:.2e})"
        for name, e in worst.items()), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_rtisi_phases: needs a CUDA card")
    sections = set(sys.argv[1:]) or {"1", "2", "3"}
    dev = torch.device("cuda", 0)
    print(f"device: {cs.smi_line()} | torch {torch.__version__}", flush=True)
    _build.library()
    if "1" in sections:
        phases(dev)
    if "2" in sections:
        sensitivity(dev)
    if "3" in sections:
        card_test_steps(dev)


if __name__ == "__main__":
    main()
