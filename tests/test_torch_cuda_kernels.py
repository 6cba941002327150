"""The port's hand-written CUDA kernels on the card.

Every test here is marked ``cuda`` and skips without a CUDA card (the CPU
tests hold the kernels' plain versions to the JAX package instead).  On a
machine with an NVIDIA GPU and nvcc, from the root of a checkout:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the port and the
GPU machine do without.)  chip_smoke.py runs the same kernels at the main
paths' shapes.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import specinv_tpu_torch as st
from specinv_tpu_torch.config import canonicalize
from specinv_tpu_torch.models.phase_init import phase_init_tm
from specinv_tpu_torch.ops import stft as stft_ops
from specinv_tpu_torch.ops import twins
from specinv_tpu_torch.ops.cuda import (
    _fullrun, admm_fullrun, admm_fused, fft, gl_fullrun, gl_fused, rtisi_fused,
)
from specinv_tpu_torch.ops.framing import pad_center
from specinv_tpu_torch.utils import runner
from specinv_tpu_torch.utils.corpus import make_speech_like

rtisi_la = importlib.import_module("specinv_tpu_torch.models.rtisi_la")

pytestmark = pytest.mark.cuda

# (module, kernel wrapper, scalar, x limit relative to the max; the limits
# of chip_smoke.py)
KERNELS = {
    "gl": (gl_fullrun, "fused_gl_run", 0.99 / 1.99, 5e-5),
    "admm": (admm_fullrun, "fused_admm_run", 0.1, 2e-3),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _state(dev, n_fft=512, hop=128, batch=2, n_samples=7800, **stft_kwargs):
    """A speech-like starting state of ``batch`` clips (SPSI seed, x0 =
    istft(seed))."""
    win_np = torch.hann_window(n_fft).numpy()
    bins = n_fft if stft_kwargs.get("onesided") is False else n_fft // 2 + 1
    cfg, w = canonicalize(bins, np.float32, window=win_np, hop_length=hop, **stft_kwargs)
    clips = np.stack([make_speech_like(n_samples, seed=s) for s in range(batch)]).astype(np.float32)
    win = torch.from_numpy(w).to(dev)
    mag = stft_ops.stft(torch.from_numpy(clips).to(dev), cfg, win).abs().contiguous()
    seed = phase_init_tm(mag, cfg).to(torch.complex64)
    T = mag.shape[-2]
    x_pad = pad_center(stft_ops.istft(seed, cfg, win), cfg).contiguous()
    inv_env = twins.make_inv_env(cfg, win, T, twins.make_geometry(cfg, T))
    return cfg, (x_pad, seed, mag, win, inv_env)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_eval_iterations_round_like_the_others(dev, name):
    """An iteration that emits |S| or the eval sums computes the same state
    bitwise as one that does not, so an early-stopping run (segments with an
    eval iteration each) follows the tol=0 trajectory exactly."""
    mod, run, scalar, _ = KERNELS[name]
    fn = getattr(mod, run)
    cfg, (x0, s0, tgt, win, inv_env) = _state(dev)
    x20, s20 = fn(x0, s0, tgt, win, inv_env, scalar, cfg, 20, emit_state=True)
    x, s = x0, s0
    for _ in range(2):
        x, s, _mag, _stats = fn(x, s, tgt, win, inv_env, scalar, cfg, 10, emit_state=True,
                                with_mag=True, with_loss=True)
    torch.cuda.synchronize()
    assert torch.equal(x, x20) and torch.equal(s, s20)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_plain_version(dev, name):
    mod, run, scalar, x_limit = KERNELS[name]
    cfg, state = _state(dev)
    before = mod.launches
    x = getattr(mod, run)(*state, scalar, cfg, 5)
    ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, 5)
    torch.cuda.synchronize()
    assert mod.launches - before == 5
    assert float((x - ref).abs().max() / ref.abs().max()) <= x_limit


# Every size the whole-run kernels and the stand-alone FFT take, each way of
# storing and scaling the spectrum, at chip_smoke.py's limits: the FFT at
# FFT_LIMIT relative to the max; one iteration of kernel A (C) at X_LIMIT,
# PLANE_LIMIT, SUM_LIMIT (ADMM_X_LIMIT, ADMM_PLANE_LIMIT, ADMM_SUM_LIMIT).
SIZES = [1 << k for k in range(4, 13)]
FFT_LIMIT = 1e-5
ITERATION_LIMITS = {"gl": (5e-5, 1e-4, 1e-4), "admm": (2e-3, 5e-3, 2e-5)}


def _rel(a, b):
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_fft_matches_plain_version_at_every_size(dev, n, onesided, normalized):
    rng = np.random.default_rng(n)
    frames = torch.from_numpy(rng.standard_normal((37, n)).astype(np.float32)).to(dev)
    before = fft.launches
    spec = fft.fft(frames, normalized, onesided)
    ref = fft.fft_reference(frames, normalized, onesided)
    bins = ref.shape[-1]
    noise = rng.standard_normal((37, bins, 2)).astype(np.float32)
    rand = torch.view_as_complex(torch.from_numpy(noise)).to(dev)
    back = fft.ifft(rand, n, normalized, onesided)
    back_ref = fft.ifft_reference(rand, n, normalized, onesided)
    torch.cuda.synchronize()
    assert fft.launches - before == 2
    assert _rel(spec, ref) <= FFT_LIMIT
    assert _rel(back, back_ref) <= FFT_LIMIT


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_iteration_matches_plain_version_at_every_size(dev, n, onesided, normalized):
    """One iteration of kernel A and one of C, hop n / 4, 2 clips, eval
    sums over all but the last 2 frames."""
    cfg, state = _state(dev, n, n // 4, n_samples=max(7800, 8 * n), onesided=onesided,
                        normalized=normalized)
    valid = state[2].shape[-2] - 2
    for name, (mod, run, scalar, _) in KERNELS.items():
        flags = dict(emit_state=True, with_mag=True, with_loss=True, valid_t=valid)
        before = mod.launches
        ours = getattr(mod, run)(*state, scalar, cfg, 1, **flags)
        ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, 1, **flags)
        torch.cuda.synchronize()
        assert mod.launches - before == 1
        x_lim, plane_lim, sum_lim = ITERATION_LIMITS[name]
        assert _rel(ours[0], ref[0]) <= x_lim, name
        assert _rel(ours[1], ref[1]) <= plane_lim, name
        assert _rel(ours[2], ref[2]) <= plane_lim, name
        assert float(((ours[3] - ref[3]).abs() / ref[3].abs()).max()) <= sum_lim, name


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_many_wave_plan_gives_each_clip_its_one_clip_bits(dev, name):
    """8 clips of 2 s at n_fft 2048, hop 512 (87 frames each, 696 a launch)
    take the many-wave frame launch, each clip alone the one-wave launch:
    5 whole-run iterations (state and |S| too) and one raw iteration give
    every clip the bits it gets alone, and the many-wave counter counts the
    batch's launches, one an iteration, and none of the clips'."""
    mod, run, scalar, _ = KERNELS[name]
    it = RAW[name][1]
    cfg, (x, s, tgt, win, env) = _state(dev, 2048, 512, batch=8, n_samples=44100)
    B, T = tgt.shape[:2]
    assert _fullrun.frame_plan(B * T, 2048).many_wave
    assert not _fullrun.frame_plan(T, 2048).many_wave
    before = mod.many_wave_launches
    whole = getattr(mod, run)(x, s, tgt, win, env, scalar, cfg, 5, emit_state=True,
                              with_mag=True)
    whole_raw = getattr(mod, it)(x, s, tgt, win, scalar, cfg, with_mag=True)
    torch.cuda.synchronize()
    assert mod.many_wave_launches - before == 6
    for b in range(B):
        one = getattr(mod, run)(x[b : b + 1], s[b : b + 1], tgt[b : b + 1], win, env, scalar,
                                cfg, 5, emit_state=True, with_mag=True)
        one_raw = getattr(mod, it)(x[b : b + 1], s[b : b + 1], tgt[b : b + 1], win, scalar, cfg,
                                   with_mag=True)
        torch.cuda.synchronize()
        assert all(torch.equal(u[b : b + 1], v) for u, v in zip(whole, one))
        assert all(torch.equal(u[b : b + 1], v) for u, v in zip(whole_raw, one_raw))
    assert mod.many_wave_launches - before == 6


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("n", [n for n in SIZES if n <= _fullrun.MANY_WAVE_MAX_N_FFT])
def test_many_wave_plan_keeps_the_bits_at_every_size(dev, n, onesided):
    """One iteration of kernel A and one of C (state and |S| too), hop n / 4,
    on 4 clips whose frames together take the many-wave launch while each
    clip alone takes the one-wave launch: every clip gets its bits alone."""
    lo, hi = 1, 1 << 20  # the fewest frames that take the many-wave plan lie in (lo, hi]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if _fullrun.frame_plan(mid, n).many_wave else (mid, hi)
    frames = -(-hi // 4)
    cfg, state = _state(dev, n, n // 4, batch=4, n_samples=(frames - 1) * (n // 4),
                        onesided=onesided)
    x, s, tgt, win, env = state
    B, T = tgt.shape[:2]
    assert _fullrun.frame_plan(B * T, n).many_wave and not _fullrun.frame_plan(T, n).many_wave
    for name, (mod, run, scalar, _) in KERNELS.items():
        before = mod.many_wave_launches
        whole = getattr(mod, run)(*state, scalar, cfg, 1, emit_state=True, with_mag=True)
        torch.cuda.synchronize()
        assert mod.many_wave_launches - before == 1, name
        for b in range(B):
            one = getattr(mod, run)(x[b : b + 1], s[b : b + 1], tgt[b : b + 1], win, env, scalar,
                                    cfg, 1, emit_state=True, with_mag=True)
            torch.cuda.synchronize()
            assert all(torch.equal(u[b : b + 1], v) for u, v in zip(whole, one)), (name, b)
        assert mod.many_wave_launches - before == 1, name


# The direct-DFT kernels: (module, wrapper, scalar, extra arguments, limits
# per tier of x / |S| / state after one iteration relative to the max; the
# limits of chip_smoke.py, from a float64 run of the plain version)
DFT_KERNELS = {
    "gl_fused": (gl_fused, "fused_gl_iteration", 0.99 / 1.99, (), {
        "high": (5e-5, 8e-6, 2e-5), "highest": (2e-5, 4e-6, 7e-6),
        "bf16x2t": (2e-4, 7e-6, 2e-5)}),
    "admm_fused": (admm_fused, "fused_admm_iteration", 0.1, (0,), {
        "high": (6e-5, 8e-6, 2e-4), "highest": (2e-5, 4e-6, 6e-5),
        "bf16x2t": (2e-5, 7e-6, 6e-5)}),
}


@pytest.mark.parametrize("name", sorted(DFT_KERNELS))
@pytest.mark.parametrize("precision", ["high", "highest", "bf16x2t"])
def test_dft_kernel_matches_plain_version_at_c7(dev, name, precision):
    """One iteration at n_fft 400 / hop 160 (ROADMAP cell C7: no power of
    two, no multiple of 16 in n_fft or F = 201)."""
    mod, run, scalar, extra, limits = DFT_KERNELS[name]
    cfg, state = _state(dev, 400, 160)
    before = mod.launches
    ours = getattr(mod, run)(*state, scalar, cfg, *extra, precision=precision)
    ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, *extra, precision=precision)
    torch.cuda.synchronize()
    assert mod.launches - before == 1

    def err(a, b):
        a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
        return float((a - b).abs().max() / b.abs().max())

    for u, v, limit in zip(ours, ref, limits[precision]):
        assert err(u, v) <= limit


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_dft_kernel_at_the_whisper_cell_shape(dev, precision):
    """One iteration of kernel E at the benchmark cell gl400_16k_batch32's
    shape: 32 chunks of 30 s at n_fft 400, hop 160, 96,032 frames a launch,
    against a float64 run of the plain version, within the 400/160 limits."""
    mod, run, scalar, extra, limits = DFT_KERNELS["gl_fused"]
    cfg, state = _state(dev, 400, 160, batch=32, n_samples=480000)
    assert state[2].shape == (32, 3001, 201)
    wide = [t.to(torch.complex128 if t.is_complex() else torch.float64) for t in state]
    before = mod.launches
    ours = getattr(mod, run)(*state, scalar, cfg, *extra, precision=precision)
    torch.cuda.synchronize()
    assert mod.launches - before == 1
    ref = getattr(mod, f"{run}_reference")(*wide, scalar, cfg, *extra, precision=precision)
    for u, v, limit in zip(ours, ref, limits[precision]):
        assert _rel(u, v) <= limit


@pytest.mark.parametrize("name", sorted(DFT_KERNELS))
@pytest.mark.parametrize("precision", ["high", "highest", "bf16x2t"])
@pytest.mark.parametrize("n_fft,hop", [(400, 100), (500, 125), (1000, 160), (4096, 1024)])
def test_dft_kernel_matches_plain_version_at_padded_shapes(dev, name, precision, n_fft, hop):
    """One iteration at B = 3 where no table row is a whole number of
    128-byte lines (n_fft 400, 500, 1000; F 201, 251, 501) or the hop frames
    at addresses that are not 16-byte aligned (hop 125), and at the largest
    n_fft; ADMM with valid_t < T (the last 3 frames' state zeroed)."""
    mod, run, scalar, extra, limits = DFT_KERNELS[name]
    cfg, state = _state(dev, n_fft, hop, batch=3, n_samples=max(7800, 4 * n_fft))
    T = state[2].shape[-2]
    if name == "admm_fused":
        extra = (T - 3,)
    before = mod.launches
    ours = getattr(mod, run)(*state, scalar, cfg, *extra, precision=precision)
    ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, *extra, precision=precision)
    torch.cuda.synchronize()
    assert mod.launches - before == 1
    if name == "admm_fused":
        assert not ours[2][:, T - 3 :].any()
    for u, v, limit in zip(ours, ref, limits[precision]):
        assert _rel(u, v) <= limit


def _dft_errors(mod, run, scalar, extra, cfg, state, precision):
    """One launch of the kernel and of its plain version from ``state``:
    the distances of x, |S| and the state, relative to the plain max."""
    before = mod.launches
    ours = getattr(mod, run)(*state, scalar, cfg, *extra, precision=precision)
    ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, *extra, precision=precision)
    torch.cuda.synchronize()
    assert mod.launches - before == 1
    return [_rel(u, v) for u, v in zip(ours, ref)]


@pytest.mark.parametrize("name", sorted(DFT_KERNELS))
@pytest.mark.parametrize("batch", [1, 3])
def test_dft_highest_matches_plain_version_at_config_1(dev, name, batch):
    """'highest' (float32 FFMA from the TMA ring) at BASELINE config 1's
    shapes (n_fft 2048, hop 512, 431 frames of 10 s) at B = 1 and 3, within
    the tier's limits."""
    mod, run, scalar, extra, limits = DFT_KERNELS[name]
    cfg, state = _state(dev, 2048, 512, batch=batch, n_samples=220500)
    assert state[2].shape == (batch, 431, 1025)
    for err, limit in zip(_dft_errors(mod, run, scalar, extra, cfg, state, "highest"),
                          limits["highest"]):
        assert err <= limit


@pytest.mark.parametrize("n_fft,hop", [(400, 160), (2048, 512)])
@pytest.mark.parametrize("pair", [("high", "highest"), ("highest", "high")])
def test_dft_mixed_pairs_match_plain_version(dev, pair, n_fft, hop):
    """A (forward, inverse) pair across the two engines: the forward writes
    P as the inverse reads it (float32 planes for a 'highest' inverse, bf16
    halves for a split one).  Each output within the larger of the two
    tiers' limits."""
    mod, run, scalar, extra, limits = DFT_KERNELS["gl_fused"]
    cfg, state = _state(dev, n_fft, hop, n_samples=max(7800, 8 * n_fft))
    bounds = [max(a, b) for a, b in zip(limits["high"], limits["highest"])]
    for err, limit in zip(_dft_errors(mod, run, scalar, extra, cfg, state, pair), bounds):
        assert err <= limit


@pytest.mark.parametrize("name", sorted(DFT_KERNELS))
def test_dft_highest_launches_repeat_their_bits(dev, name):
    """Two launches of 'highest' from the same state give the same bits
    (every sum in a fixed order, no atomics), at 400/160 with B = 3 and at
    config 1."""
    mod, run, scalar, extra, _ = DFT_KERNELS[name]
    for n_fft, hop, batch, n_samples in ((400, 160, 3, 7800), (2048, 512, 1, 220500)):
        cfg, state = _state(dev, n_fft, hop, batch=batch, n_samples=n_samples)
        fn = getattr(mod, run)
        a = fn(*state, scalar, cfg, *extra, precision="highest")
        b = fn(*state, scalar, cfg, *extra, precision="highest")
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("tol", [1.0, 1e-6])
def test_dft_griffin_lim_selects_at_evaluations(dev, tol):
    """A 100-iteration 'dft' call at 400/160 on a few clips launches kernel E
    100 times and selects the kept state at most 11 times (once per
    evaluation plus one, utils/runner), and gives the 'while' result, with
    the stop firing (tol 1.0: at the second evaluation) or as it comes."""
    cfg, (_x, _s, tgt, win, _env) = _state(dev, 400, 160, batch=4, n_samples=48000)
    mag = tgt.transpose(-1, -2).contiguous()  # (B, F, T), as callers hand it over
    kw = dict(max_iter=100, tol=tol, eva_iter=10, verbose=False, hop_length=160,
              window=win, backend="dft")
    launches, selects = gl_fused.launches, runner.state_selects
    a = st.griffin_lim(mag, mode="fori", **kw)
    torch.cuda.synchronize()
    assert gl_fused.launches - launches == 100
    assert runner.state_selects - selects <= 11
    b = st.griffin_lim(mag, mode="while", **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,precision", [
    ("gl_fused", "high"), ("gl_fused", ("high", "highest")), ("gl_fused", ("highest", "high")),
    ("admm_fused", "high"), ("admm_fused", "bf16x2t")])
def test_dft_bound_iterations_equal_single_calls(dev, name, precision):
    """The 'dft' loop's bound iteration (bind: checks, tables and scratch
    made once, the scratch reused) gives each of 3 chained iterations the
    bits of the public one-call wrapper; with a (forward, inverse) pair P
    passes through the bf16 planes (a split inverse) or the float32 ones (a
    'highest' one)."""
    mod, run, scalar, extra, _ = DFT_KERNELS[name]
    cfg, (x, s, tgt, win, env) = _state(dev, 400, 160)
    iteration = mod.bind(tgt, win, env, scalar, cfg, *extra, precision=precision)
    a = b = (x, s)
    for _ in range(3):
        xa, ma, sa = iteration(*a)
        xb, mb, sb = getattr(mod, run)(*b, tgt, win, env, scalar, cfg, *extra,
                                       precision=precision)
        a, b = (xa, sa), (xb, sb)
        torch.cuda.synchronize()
        assert torch.equal(xa, xb) and torch.equal(ma, mb) and torch.equal(sa, sb)


@pytest.mark.parametrize("name", sorted(DFT_KERNELS))
def test_dft_state_does_not_depend_on_the_mag_output(dev, name):
    """The state and the signal are bitwise equal with the magnitude output
    on and off (the middle's products and sums are rounded one by one)."""
    mod, run, scalar, extra, _ = DFT_KERNELS[name]
    cfg, (x, s, tgt, win, env) = _state(dev)
    fn = getattr(mod, run)
    a, b = (x, s), (x, s)
    for _ in range(5):
        xa, mag, sa = fn(*a, tgt, win, env, scalar, cfg, *extra, with_mag=True)
        xb, none, sb = fn(*b, tgt, win, env, scalar, cfg, *extra, with_mag=False)
        a, b = (xa, sa), (xb, sb)
    torch.cuda.synchronize()
    assert none is None and mag is not None
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name", sorted(DFT_KERNELS))
def test_dft_batch_equals_single_clips(dev, name):
    """A batch of 3 clips gives each clip the bits it gets alone: one
    iteration of the kernel, and the whole 'dft' path of griffin_lim / ADMM
    from a complex spectrogram (no phase seed)."""
    mod, run, scalar, extra, _ = DFT_KERNELS[name]
    cfg, (x, s, tgt, win, env) = _state(dev, batch=3)
    fn = getattr(mod, run)
    whole = fn(x, s, tgt, win, env, scalar, cfg, *extra)
    for b in range(3):
        one = fn(x[b : b + 1], s[b : b + 1], tgt[b : b + 1], win, env, scalar, cfg, *extra)
        assert all(torch.equal(u[b : b + 1], v) for u, v in zip(whole, one))
    algo = st.griffin_lim if name == "gl_fused" else st.ADMM
    spec = torch.polar(tgt, torch.angle(s)).transpose(-1, -2).contiguous()  # (B, F, T)
    kw = dict(max_iter=10, tol=0.0, backend="dft", hop_length=128, window=win, verbose=False)
    before = mod.launches
    y3 = algo(spec, **kw)
    ys = [algo(spec[b : b + 1], **kw) for b in range(3)]
    torch.cuda.synchronize()
    assert mod.launches - before == 40
    assert all(torch.equal(y3[b : b + 1], ys[b]) for b in range(3))


@functools.lru_cache(maxsize=1)
def _whisper_chunks(dev):
    """3 speech-like 30 s chunks at n_fft 400, hop 160 (3,001 frames each):
    564 tiles a product together, 4 or 5 a CTA of the persistent kernel on
    an H100's 132 SMs; a chunk alone 188, 1 or 2 a CTA."""
    return _state(dev, 400, 160, batch=3, n_samples=480000)


@pytest.mark.parametrize("name", sorted(DFT_KERNELS))
@pytest.mark.parametrize("precision", ["high", "bf16x2t", "default"])
def test_dft_persistent_products_give_each_chunk_its_one_chunk_bits(dev, name, precision):
    """One iteration of 3 chunks of 30 s at 400/160 gives every chunk (x, |S|
    and the state) the bits it gets alone, though the persistent kernel's
    CTAs walk more of the batch's tiles than of a chunk's; both products
    run on it."""
    mod, run, scalar, extra, _ = DFT_KERNELS[name]
    cfg, (x, s, tgt, win, env) = _whisper_chunks(dev)
    fn = getattr(mod, run)
    before = mod.persistent_products
    whole = fn(x, s, tgt, win, env, scalar, cfg, *extra, precision=precision)
    torch.cuda.synchronize()
    assert mod.persistent_products - before == 2
    for b in range(tgt.shape[0]):
        one = fn(x[b : b + 1], s[b : b + 1], tgt[b : b + 1], win, env, scalar, cfg, *extra,
                 precision=precision)
        torch.cuda.synchronize()
        assert all(torch.equal(u[b : b + 1], v) for u, v in zip(whole, one)), b


@pytest.mark.parametrize("precision,per_iteration", [
    ("high", 2), ("bf16x2", 2), (("high", "highest"), 1), (("highest", "high"), 1),
    ("highest", 0)])
def test_dft_griffin_lim_counts_persistent_products(dev, precision, per_iteration):
    """griffin_lim(backend='dft') counts its products on the persistent
    kernel, two an iteration in a bf16 scheme and none in 'highest' (whose
    FFMA kernel takes a tile per CTA), at config 1 (one 10 s clip at n_fft
    2048: 119 forward tiles, fewer than an H100's SMs) as at 3 chunks of 30 s
    at 400/160."""
    for cfg, (_x, _s, tgt, win, _env) in (_state(dev, 2048, 512, batch=1, n_samples=220500),
                                          _whisper_chunks(dev)):
        mag = tgt.transpose(-1, -2).contiguous()  # (B, F, T), as callers hand it over
        before, launches = gl_fused.persistent_products, gl_fused.launches
        st.griffin_lim(mag, hop_length=cfg.hop_length, window=win, max_iter=3, tol=0.0,
                       verbose=False, backend="dft", precision=precision)
        torch.cuda.synchronize()
        assert gl_fused.launches - launches == 3
        assert gl_fused.persistent_products - before == 3 * per_iteration


def _rtisi_input(dev, batch, seconds):
    """BASELINE config 3's widths (n_fft 2048, hop 512, hann, look-ahead 3,
    25 refinements) on ``batch`` speech-like clips: ``(mag (B, F, T), kw)``."""
    clips = np.stack([make_speech_like(int(22050 * seconds), seed=s) for s in range(batch)])
    window = torch.hann_window(2048, device=dev)
    mag = st.stft(torch.from_numpy(clips.astype(np.float32)).to(dev), 2048, hop_length=512,
                  window=window).abs()
    return mag, dict(look_ahead=3, max_iter=25, hop_length=512, window=window)


def test_rtisi_frames_per_launch_and_streamer_are_bitwise(dev, monkeypatch):
    """frames_per_launch 1, 3 and 8 and the streamer (one launch of one step
    per push) commit the same frames bit for bit: a step computes the same
    whether it is the first of a launch or a later one."""
    mag, kw = _rtisi_input(dev, 1, 3.0)
    T = mag.shape[-1]
    recorded, synthesize = [], rtisi_la.synthesize

    def record(frames, *args):  # the committed frames the offline call synthesizes
        recorded.append(frames)
        return synthesize(frames, *args)

    monkeypatch.setattr(rtisi_la, "synthesize", record)
    for fpl in (8, 3, 1):
        before = rtisi_fused.launches
        st.RTISI_LA(mag[0], backend="kernel", frames_per_launch=fpl, verbose=False, **kw)
        assert rtisi_fused.launches - before == -(-(T + 3) // fpl)

    class Recording(st.RTISIStreamer):
        def _emit(self, committed):
            self.committed.append(committed)
            return super()._emit(committed)

    streamer = Recording(1025, backend="kernel", **kw)
    streamer.committed = []
    before = rtisi_fused.launches
    for t in range(T):
        streamer.push(mag[0, :, t])
    streamer.flush()
    torch.cuda.synchronize()
    assert rtisi_fused.launches - before == T + 3
    for frames in (*recorded[1:], torch.stack(streamer.committed)):
        assert torch.equal(frames, recorded[0])


def test_rtisi_chunk_rows_is_bitwise(dev):
    """Batches split into sequential launches by ``chunk_rows`` give the
    same samples bit for bit, offline and streaming."""
    mag, kw = _rtisi_input(dev, 5, 1.0)
    base = st.RTISI_LA(mag, backend="kernel", verbose=False, **kw)
    for rows in (4, 8):  # 1 and 2 streams per launch
        assert torch.equal(st.RTISI_LA(mag, backend="kernel", chunk_rows=rows, verbose=False,
                                       **kw), base)

    def stream(**extra):
        s = st.RTISIStreamer(1025, batch=5, backend="kernel", **kw, **extra)
        outs = [s.push(mag[..., t]) for t in range(mag.shape[-1])]
        return torch.cat([o for o in outs if o is not None] + [s.flush()], dim=1)

    assert torch.equal(stream(chunk_rows=8), stream())


# One step of the RTISI kernel against its plain version, 5 refinements, from
# a state the plain version advanced 4 steps from the zero-phase seed.  Over
# the shapes below the kernel / plain float32 step lay at most this far from
# a float64 plain step from the same state (relative to the max; largest sum
# of the two sides; scripts/torch_rtisi_phases.py section 3 on one NVIDIA
# H100 80GB HBM3, 700 W): committed frames 4.7e-7 / 1.4e-6, in flight 2.0e-6
# / 2.9e-6, momentum 7.3e-6 / 5.5e-6.  Each limit is twice that sum, rounded
# up to one digit.
RTISI_STEP_LIMITS = {"committed": 4e-6, "keeped": 4e-6, "update": 1e-5, "pre": 3e-5}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("look_ahead", [0, 3, -1])
@pytest.mark.parametrize("n_fft", [16, 256, 4096])
def test_rtisi_step_matches_plain_version(dev, n_fft, look_ahead, batch):
    """hop n_fft / 16, so look_ahead -1 keeps R = 16 frames in flight: more
    frames than a cluster's 8 CTAs (two per CTA), in device memory at
    n_fft 4096 (the plan's streamed state); look-ahead 0 is a cluster of one."""
    hop = n_fft // 16
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    cfg, w = canonicalize(n_fft // 2 + 1, np.float32, window=win, hop_length=hop)
    window = torch.from_numpy(w).to(dev)
    clips = np.stack([make_speech_like(max(4000, 24 * hop + n_fft), seed=s) for s in range(batch)])
    mag = stft_ops.stft(torch.from_numpy(clips.astype(np.float32)).to(dev), cfg, window).abs()
    nk = (n_fft - 1) // hop
    la = nk if look_ahead < 0 else look_ahead
    target = torch.nn.functional.pad(mag, (0, 0, la, la)).contiguous()
    state = (torch.zeros(batch, nk, n_fft, device=dev), rtisi_la._seed_update(target, la, cfg),
             torch.zeros(batch, la + 1, n_fft // 2 + 1, dtype=torch.complex64, device=dev))
    windows = rtisi_la.rtisi_windows(window, cfg, False)
    lr, iters = 0.99 / 1.99, 5
    _, *state = rtisi_fused.fused_rtisi_steps_reference(*state, target[:, : 4 + la], windows, lr,
                                                        cfg, iters)
    tgt = target[:, 4 : 5 + la].contiguous()
    before = rtisi_fused.launches
    ours = rtisi_fused.fused_rtisi_steps(*state, tgt, windows, lr, cfg, iters)
    ref = rtisi_fused.fused_rtisi_steps_reference(*state, tgt, windows, lr, cfg, iters)
    torch.cuda.synchronize()
    assert rtisi_fused.launches - before == 1
    for name, a, b in zip(RTISI_STEP_LIMITS, ours, ref):
        if b.numel():
            a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
            err = float((a.double() - b.double()).abs().max() / max(float(b.abs().max()), 1e-30))
            assert err <= RTISI_STEP_LIMITS[name], (name, err)


# Kernel D where n_fft / 2 is 2^a 3^b 5^c and no power of two: the mixed-radix
# stages of csrc/rfft.cuh (400 / 160: one radix-8 and two radix-5 stages;
# 450 / 150: n_fft / 2 = 225 is odd, so D's bin pairs have no middle bin).
MIXED_RADIX = [(400, 160), (320, 80), (480, 120), (1200, 300), (450, 150)]


def _mixed_case(dev, n_fft, hop, batch, seconds, sr=16000):
    """Speech-like clips' magnitudes (B, F, T) at a periodic hann window."""
    clips = np.stack([make_speech_like(int(sr * seconds), sr=sr, seed=s) for s in range(batch)])
    window = torch.hann_window(n_fft, device=dev)
    mag = st.stft(torch.from_numpy(clips.astype(np.float32)).to(dev), n_fft, hop_length=hop,
                  window=window).abs()
    return mag, window


def _rel_max(a, b) -> float:
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    return float((a.double() - b.double()).abs().max() / max(float(b.abs().max()), 1e-30))


@pytest.mark.parametrize("n_fft,hop", MIXED_RADIX)
def test_rtisi_mixed_radix_steps_match_plain_version(dev, n_fft, hop):
    """At the entry's default look-ahead ((n_fft - 1) // hop), 8 one-step
    launches, each from the plain version's state (5 refinements, as the
    power-of-two cases), against the plain float32 step and a float64 one:
    the committed and kept frames within RTISI_STEP_LIMITS of the plain
    version; the in-flight frames and the momentum too, or, where the
    geometry makes float32 rounding itself move them further, no farther
    from float64 than twice the plain float32 version is.  At 400 / 160
    and 1200 / 300 the newest frame's projection is so ill-conditioned that
    the float64 step moves its update by 2e-3 to 9e-3 (and its momentum by
    1e-3 to 4e-3) when the state moves by one float32 rounding, at 450 / 150
    by 7e-5 to 1e-4 (4e-5 to 6e-5), all above the 1e-5 limit, while the
    kernel lay at most 0.4 to 0.5 of the plain float32 version's distance
    from float64 (an NVIDIA H100 80GB HBM3, 700 W).
    Then: an 8-step launch commits what 8 one-step launches from the
    kernel's own states commit, bit for bit, and every launch counts as a
    mixed-radix one."""
    mag, window = _mixed_case(dev, n_fft, hop, 3, 1.0)
    cfg, _ = canonicalize(n_fft // 2 + 1, np.float32, window=window.cpu().numpy(),
                          hop_length=hop)
    nk = (n_fft - 1) // hop
    la, steps, lr, iters = nk, 8, 0.99 / 1.99, 5
    target = torch.nn.functional.pad(mag.transpose(-1, -2), (0, 0, la, la)).contiguous()
    state = (torch.zeros(3, nk, n_fft, device=dev), rtisi_la._seed_update(target, la, cfg),
             torch.zeros(3, la + 1, n_fft // 2 + 1, dtype=torch.complex64, device=dev))
    windows = rtisi_la.rtisi_windows(window, cfg, False)
    w64 = type(windows)(*(w.double() for w in windows))
    _, *state = rtisi_fused.fused_rtisi_steps_reference(*state, target[:, : 4 + la], windows, lr,
                                                        cfg, iters)
    tgt = target[:, 4 : 4 + steps + la].contiguous()
    before = (rtisi_fused.launches, rtisi_fused.mixed_radix_launches)
    # per output, the worst (kernel - plain, kernel - float64, plain - float64)
    worst = {name: (0.0, 0.0, 0.0) for name in RTISI_STEP_LIMITS}
    plain = state
    for i in range(steps):
        rows = tgt[:, i : i + la + 1].contiguous()
        ours = rtisi_fused.fused_rtisi_steps(*plain, rows, windows, lr, cfg, iters)
        ref = rtisi_fused.fused_rtisi_steps_reference(*plain, rows, windows, lr, cfg, iters)
        wide = (t.to(torch.complex128 if t.is_complex() else torch.float64) for t in (*plain, rows))
        f64 = rtisi_fused.fused_rtisi_steps_reference(*wide, w64, lr, cfg, iters)
        for name, a, b, c in zip(RTISI_STEP_LIMITS, ours, ref, f64):
            worst[name] = tuple(map(max, worst[name], (_rel_max(a, b), _rel_max(a, c),
                                                       _rel_max(b, c))))
        plain = ref[1:]
    for name, (ours_plain, ours_f64, plain_f64) in worst.items():
        held = ours_plain <= RTISI_STEP_LIMITS[name]
        if name in ("update", "pre"):
            held = held or ours_f64 <= 2 * plain_f64
        assert held, (name, worst[name])
    whole = rtisi_fused.fused_rtisi_steps(*state, tgt, windows, lr, cfg, iters)
    chain, coms = state, []
    for i in range(steps):
        com, *chain = rtisi_fused.fused_rtisi_steps(*chain, tgt[:, i : i + la + 1].contiguous(),
                                                    windows, lr, cfg, iters)
        coms.append(com)
    torch.cuda.synchronize()
    assert torch.equal(whole[0], torch.cat(coms))
    assert all(torch.equal(a, b) for a, b in zip(whole[1:], chain))
    launches = 2 * steps + 1
    assert (rtisi_fused.launches - before[0], rtisi_fused.mixed_radix_launches - before[1]) == (
        launches, launches)


@pytest.mark.parametrize("n_fft,hop", MIXED_RADIX)
def test_rtisi_mixed_radix_auto_runs_kernel_d_offline_and_streaming(dev, n_fft, hop,
                                                                    monkeypatch):
    """RTISI_LA and RTISIStreamer on 'auto' (25 refinements, the default
    look-ahead) launch kernel D, 8 steps a launch offline and one a push,
    and commit the same frames bit for bit."""
    mag, window = _mixed_case(dev, n_fft, hop, 2, 0.5)
    T, la = mag.shape[-1], (n_fft - 1) // hop
    recorded, synthesize = [], rtisi_la.synthesize

    def record(frames, *args):
        recorded.append(frames)
        return synthesize(frames, *args)

    monkeypatch.setattr(rtisi_la, "synthesize", record)
    before = (rtisi_fused.launches, rtisi_fused.mixed_radix_launches)
    st.RTISI_LA(mag, look_ahead=-1, hop_length=hop, window=window, verbose=False)
    assert (rtisi_fused.launches - before[0], rtisi_fused.mixed_radix_launches - before[1]) == (
        -(-(T + la) // 8),) * 2

    class Recording(st.RTISIStreamer):
        def _emit(self, committed):
            self.committed.append(committed)
            return super()._emit(committed)

    streamer = Recording(n_fft // 2 + 1, look_ahead=-1, batch=2, hop_length=hop, window=window)
    streamer.committed = []
    before = rtisi_fused.mixed_radix_launches
    for t in range(T):
        streamer.push(mag[..., t])
    streamer.flush()
    torch.cuda.synchronize()
    assert streamer.backend == "kernel"
    assert rtisi_fused.mixed_radix_launches - before == T + la
    assert torch.equal(torch.stack(streamer.committed), recorded[0])


# --- the raw per-iteration dispatch (K4, K6) ---------------------------------

RAW = {
    "gl": (gl_fullrun, "fused_gl_iteration", "fused_gl_run", 0.99 / 1.99, 5e-5),
    "admm": (admm_fullrun, "fused_admm_iteration", "fused_admm_run", 0.1, 2e-3),
}


@pytest.mark.parametrize("name", sorted(RAW))
def test_raw_dispatch_is_the_normalised_one_before_its_envelope(dev, name):
    """The raw dispatch stops at the raw overlap-add: times the envelope and
    re-padded in PyTorch it is one whole-run launch bit for bit (the kernel
    multiplies the same float32 sum by the same factor and copies the edge
    samples), the state bit for bit too; and each counts one launch."""
    mod, it, run, scalar, _ = RAW[name]
    cfg, (x, s, tgt, win, env) = _state(dev)
    geo = twins.make_geometry(cfg, tgt.shape[-2])
    before = (mod.iteration_launches, mod.launches)
    xr, sr = getattr(mod, it)(x, s, tgt, win, scalar, cfg)
    xw, sw = getattr(mod, run)(x, s, tgt, win, env, scalar, cfg, 1, emit_state=True)
    torch.cuda.synchronize()
    assert (mod.iteration_launches, mod.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(sr, sw)
    assert torch.equal(twins.repad_edges(xr * env, cfg, geo), xw)


@pytest.mark.parametrize("name", sorted(RAW))
def test_raw_dispatch_matches_plain_version(dev, name):
    """Against the plain version at valid_t of all, part and none of the
    frames (a shard of padding rows: ADMM zeroes every Y, the eval sums
    are 0); x at the limit of the whole-run kernel (chip_smoke.py)."""
    mod, it, _, scalar, x_limit = RAW[name]
    cfg, (x, s, tgt, win, _) = _state(dev)
    T = tgt.shape[-2]
    for valid in (None, T - 5, 0):
        flags = dict(with_mag=True, with_loss=True, valid_t=valid)
        ours = getattr(mod, it)(x, s, tgt, win, scalar, cfg, **flags)
        ref = getattr(mod, f"{it}_reference")(x, s, tgt, win, scalar, cfg, **flags)
        torch.cuda.synchronize()
        torch.testing.assert_close(ours[3], ref[3], rtol=1e-4, atol=0)
        if valid == 0:
            assert not bool(ours[3].any())
            if name == "admm":  # every Y zeroed: no frame, no sample
                assert not bool(ours[1].abs().any()) and not bool(ours[0].any())
                continue
        assert float((ours[0] - ref[0]).abs().max() / ref[0].abs().max()) <= x_limit


def _golden_inputs(dev, n_fft=512, hop=128, batch=2, frames=40):
    """Seeded float32 inputs made on the CPU with numpy, so that nothing but
    the kernel runs on the card: x_pad, a Hermitian state, target, hann
    window and the inverse envelope."""
    rng = np.random.default_rng(2024)
    cfg, w = canonicalize(n_fft // 2 + 1, np.float32, window=np.hanning(n_fft + 1)[:-1],
                          hop_length=hop)
    geo = twins.make_geometry(cfg, frames)
    x = rng.standard_normal((batch, geo.lp)).astype(np.float32)
    tgt = np.abs(rng.standard_normal((batch, frames, n_fft // 2 + 1))).astype(np.float32)
    state = tgt * np.exp(1j * rng.uniform(0, 2 * np.pi, tgt.shape))
    state[..., 0] = state[..., 0].real  # DC and Nyquist bins of a real signal are real
    state[..., -1] = state[..., -1].real
    win = torch.from_numpy(w.astype(np.float32))
    env = twins.make_inv_env(cfg, win, frames, geo)
    return cfg, [torch.from_numpy(a).to(dev) for a in
                 (x, state.astype(np.complex64), tgt)] + [win.to(dev), env.to(dev)]


def golden_digests(dev):
    """sha256 of every output of 5 whole-run iterations (A, C) and of one
    direct-DFT iteration at 'high' (E, F) on :func:`_golden_inputs`: the
    launches ``ola_kernel`` serves, which its raw-overlap-add branch must
    leave as they were."""
    import hashlib

    cfg, (x, s, tgt, win, env) = _golden_inputs(dev)
    outs = {
        "gl_fullrun": gl_fullrun.fused_gl_run(x, s, tgt, win, env, 0.99 / 1.99, cfg, 5,
                                              emit_state=True, with_mag=True, with_loss=True),
        "admm_fullrun": admm_fullrun.fused_admm_run(x, s, tgt, win, env, 0.1, cfg, 5,
                                                    emit_state=True, with_mag=True,
                                                    with_loss=True),
        "gl_fused": gl_fused.fused_gl_iteration(x, s, tgt, win, env, 0.99 / 1.99, cfg,
                                                precision="high", with_mag=True),
        "admm_fused": admm_fused.fused_admm_iteration(x, s, tgt, win, env, 0.1, cfg, 0,
                                                      precision="high", with_mag=True),
    }
    torch.cuda.synchronize()
    return {name: hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes() for t in ts))
            .hexdigest() for name, ts in outs.items()}


# The digests read on an NVIDIA H100 80GB HBM3.  A and C's (gl_fullrun,
# admm_fullrun) from their frame launch on the half-length real FFT of
# csrc/rfft.cuh in FP64, which changed their bits on purpose (the complex
# radix-2 FFT before it read 3a734c0f... and 16392df5...).  E and F's
# (gl_fused, admm_fused) from the engine's split products on wgmma (one
# product of depth 2F in the inverse, float32 sums per 64-deep stage), which
# changed their bits on purpose: the WMMA design before it read 8866415c...
# and d07eebe7....
GOLDEN = {
    "gl_fullrun": "8232942746451fe98d88798726c8f83bbd079d18bab2b4a057d7da7ea7798189",
    "admm_fullrun": "14cc753a97fad70ca338832c87362ee0116a29ced28cc995de5d61bca7b25b57",
    "gl_fused": "4445b93fd109b5854da920c5f4e1ced9961c1aab292990b32bc0b3b171e87187",
    "admm_fused": "3520d526bf68faedb8615101e7a0c73aea5731d21e094d1f9c53b367042601e2",
}


def test_existing_launches_unchanged_by_the_raw_branch(dev):
    assert golden_digests(dev) == GOLDEN


def rtisi_digests(dev):
    """sha256 of every output of one launch of kernel D of one step and one
    of 8 steps at BASELINE config 3's widths (n_fft 2048, hop 512, hann,
    look-ahead 3, 25 refinements), B = 1, from one state made on the CPU
    with numpy (seed 2025): the frames keep and upd, the momentum pre and the
    target rows."""
    import hashlib

    rng = np.random.default_rng(2025)
    n_fft, hop, la, steps = 2048, 512, 3, 8
    cfg, w = canonicalize(n_fft // 2 + 1, np.float32, window=np.hanning(n_fft + 1)[:-1],
                          hop_length=hop)
    nk, R, F = (n_fft - 1) // hop, la + 1, n_fft // 2 + 1
    keep = 0.05 * rng.standard_normal((1, nk, n_fft))
    upd = 0.05 * rng.standard_normal((1, R, n_fft))
    pre = rng.standard_normal((1, R, F)) + 1j * rng.standard_normal((1, R, F))
    target = np.abs(rng.standard_normal((1, steps + la, F)))
    state = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (keep, upd)]
    state.append(torch.from_numpy(pre.astype(np.complex64)).to(dev))
    target = torch.from_numpy(target.astype(np.float32)).to(dev)
    windows = rtisi_la.rtisi_windows(torch.from_numpy(w.astype(np.float32)).to(dev), cfg, False)
    outs = {f"steps{k}": rtisi_fused.fused_rtisi_steps(*state, target[:, : k + la].contiguous(),
                                                       windows, 0.99 / 1.99, cfg, 25)
            for k in (1, steps)}
    torch.cuda.synchronize()
    return {name: hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes() for t in ts))
            .hexdigest() for name, ts in outs.items()}


# Kernel D's digests on the tree before kernels A, B and C came to share its
# transform (csrc/rfft.cuh), read on an NVIDIA H100 80GB HBM3: D must keep
# its bits.
RTISI_GOLDEN = {
    "steps1": "d9e05c65518e03d6a02af68098c9dd0a6dcc63a684ba56a7be78604c07e800c1",
    "steps8": "8a787cb7a4473f52aa3113a1b28016acee213fd86a01db6f8dcbdc27da7a06cb",
}


def test_rtisi_launches_keep_their_bits(dev):
    assert rtisi_digests(dev) == RTISI_GOLDEN
