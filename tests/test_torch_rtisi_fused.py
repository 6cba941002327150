"""The module that holds the RTISI-LA kernel, on the CPU.

fused_rtisi_steps takes its plain version (rtisi_steps_twin) for CPU
tensors.  It is held against the JAX kernel rtisi_la._kernel_multi_steps
(rtisi_fused4._kernel_multi) in Pallas interpret mode at precision=HIGHEST,
one launch of k steps from a real state: a JAX kernel-mode streamer's state
after a few frames, carried across by convert.rtisi_state_from_jax.  The
band is derived below from a float64 run of the plain version.  In float64
the plain twin equals the literal fft-path step to 1e-10.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specinv_tpu.config import canonicalize as jcanon
from specinv_tpu.ops.pallas import fft4
from specinv_tpu_torch import convert
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.ops import twins
from specinv_tpu_torch.ops.cuda import rtisi_fused

from .helpers import make_signal, torch_stft

jrt = importlib.import_module("specinv_tpu.models.rtisi_la")
trt = importlib.import_module("specinv_tpu_torch.models.rtisi_la")

N_FFT, HOP, LA, B, K, ITERS = 512, 128, 2, 2, 5, 3
LR = 0.99 / 1.99

# One launch of K=5 steps, 3 refinements, from the state after 8 frames,
# float32 on both sides.  Against the plain version in float64 from the same
# state (measured on the CPU; sym / asym): the port's committed frames lie 1.5e-6 /
# 9.3e-7 of the max from it, JAX's 2.7e-6 / 4.2e-6; the in-flight frames
# 1.8e-6 / 1.8e-6 and 3.9e-6 / 4.6e-6; the momentum 5.4e-6 / 5.0e-6 and
# 1.4e-5 / 1.6e-5.  Each band is twice the larger sum of the two sides,
# rounded up to one digit; the port's own drift is held to half of it.
BANDS = {"committed": 2e-5, "keeped": 2e-5, "update": 2e-5, "pre": 5e-5}


def _frames(n_frames, batch=B):
    x = make_signal((batch, 6000), dtype=np.float32)
    win = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    mag = np.abs(torch_stft(x, N_FFT, hop_length=HOP, window=win)).astype(np.float32)
    return win, mag[..., :n_frames]          # (B, F, T)


def _jax_kernel_state(asym):
    """A real state: the JAX kernel-mode streamer after 8 frames, and the
    step window that follows them."""
    win, mag = _frames(8 + K + LA)
    js = jrt.RTISIStreamer(num_freqs=mag.shape[1], look_ahead=LA, asymmetric_window=asym,
                           max_iter=ITERS, batch=B, backend="pallas4", window=win,
                           hop_length=HOP)
    for t in range(8):
        js.push(mag[:, :, t])
    # the target window of the next K steps: the LA pending frames and K more
    target = np.swapaxes(mag[:, :, 8 - LA : 8 + K], 1, 2)   # (B, K + LA, F)
    return win, js.state, np.ascontiguousarray(target)


def _jax_launch(win, state, target, asym):
    keeped, update, (re_bm, im_bm) = state
    nk, R = keeped.shape[1], update.shape[1]
    fm = lambda a: jnp.swapaxes(jnp.asarray(a), 0, 1).reshape(-1, N_FFT)  # noqa: E731
    steps = []
    for s in range(K):
        win_s = jnp.swapaxes(jnp.asarray(target[:, s : s + R]), 0, 1)   # (R, B, F)
        full = fft4.extend_hermitian_mag(win_s, N_FFT)
        steps.append(fft4.to_permuted(full, N_FFT).reshape(R * B, N_FFT))
    cfg, _ = jcanon(N_FFT // 2 + 1, np.float32, window=win, hop_length=HOP)
    (keep, upd, p_re, p_im), com = jrt._kernel_multi_steps(
        fm(keeped), fm(update), fm(re_bm), fm(im_bm), jnp.stack(steps), jnp.asarray(win),
        jnp.float32(LR), cfg, look_ahead=LA, asymmetric_window=asym, max_iter=ITERS,
        interpret=True, precision=jax.lax.Precision.HIGHEST)
    bm = lambda a, rows: np.swapaxes(np.asarray(a).reshape(rows, B, -1), 0, 1)  # noqa: E731
    pre = convert.rtisi_state_from_jax(
        (keep, upd, (bm(p_re, R).reshape(B, R, -1, 128), bm(p_im, R).reshape(B, R, -1, 128))))[2]
    return np.asarray(com), bm(keep, nk), bm(upd, R), pre


def _port_launch(win, keeped, update, pre, target, asym, dtype=torch.float32):
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    cfg, w = tcanon(N_FFT // 2 + 1, np.float32, window=win, hop_length=HOP)
    windows = trt.rtisi_windows(torch.from_numpy(w).to(dtype), cfg, asym)
    t = lambda a, d=dtype: torch.from_numpy(np.asarray(a)).to(d)  # noqa: E731
    return rtisi_fused.fused_rtisi_steps(t(keeped), t(update), t(pre, cdtype), t(target),
                                         windows, LR, cfg, ITERS)


@pytest.mark.parametrize("asym", [False, True])
def test_plain_version_matches_jax_kernel(asym):
    win, state, target = _jax_kernel_state(asym)
    keeped, update, pre = convert.rtisi_state_from_jax(state)
    assert keeped.shape == (B, (N_FFT - 1) // HOP, N_FFT) and pre.shape == (B, LA + 1, 257)
    ref = _jax_launch(win, state, target, asym)
    ours = _port_launch(win, keeped, update, pre, target, asym)
    anchor = _port_launch(win, keeped, update, pre, target, asym, torch.float64)
    for name, o, r, a in zip(("committed", "keeped", "update", "pre"), ours, ref, anchor):
        o, a = o.numpy(), a.numpy()
        assert o.shape == r.shape, name
        scale = np.abs(a).max()
        assert np.abs(o - a).max() <= BANDS[name] / 2 * scale, name
        np.testing.assert_allclose(o, r, atol=BANDS[name] * scale, rtol=0, err_msg=name)


def test_state_conversion_kernel_layout():
    """One step of the JAX kernel-mode streamer and of its XLA streamer from
    the same frames, converted: they agree to 7.6e-5 (committed), 1.2e-4
    (in flight) and 3.7e-4 (momentum) of the max (measured on the CPU: two float32
    FFTs, whose rounding the newest frame's refinements amplify), held at
    1e-3.  Momentum frames in the wrong order differ by 1.15 of the max."""
    win, mag = _frames(LA + 1)
    states = {}
    for backend in ("pallas4", "fft"):
        js = jrt.RTISIStreamer(num_freqs=mag.shape[1], look_ahead=LA, max_iter=2, batch=B,
                               backend=backend, window=win, hop_length=HOP)
        for t in range(LA + 1):
            js.push(mag[:, :, t])
        states[backend] = convert.rtisi_state_from_jax(js.state)
    for ours, ref in zip(states["pallas4"], states["fft"]):
        assert ours.shape == ref.shape and ours.dtype == np.asarray(ref).dtype
        np.testing.assert_allclose(ours, ref, atol=1e-3 * np.abs(ref).max(), rtol=0)


def _state64(n_fft, hop, la, steps=6):
    """A float64 state of the port's fft path after ``steps`` steps of a
    speech-like clip, and the target window of the steps after."""
    from specinv_tpu_torch.utils.corpus import make_speech_like

    win = np.hanning(n_fft + 1)[:-1]
    cfg, w = tcanon(n_fft // 2 + 1, np.float64, window=win, hop_length=hop)
    w = torch.from_numpy(w)
    x = torch.from_numpy(make_speech_like(8 * n_fft + 4000, seed=1))[None]
    from specinv_tpu_torch.ops import stft as so

    tp = torch.nn.functional.pad(so.stft(x, cfg, w).abs(), (0, 0, la, la))
    nk = (n_fft - 1) // hop
    state = trt.RTISIState(torch.zeros(1, nk, n_fft, dtype=torch.float64),
                           trt._seed_update(tp, la, cfg),
                           torch.zeros(1, la + 1, n_fft // 2 + 1, dtype=torch.complex128))
    for i in range(steps):
        state, _ = trt._frame_step(state, tp[:, i : i + la + 1], w, LR, cfg, la, True, 2)
    return cfg, w, tp[:, steps:], state


@pytest.mark.parametrize("n_fft,hop,la,asym", [
    (512, 128, 3, False), (512, 128, 2, True), (512, 128, 0, True), (256, 256, 1, False),
    (512, 160, 3, True), (128, 16, 9, False),
])
def test_plain_twin_equals_fft_step_f64(n_fft, hop, la, asym):
    """k chained twin steps equal k literal steps in float64 (the same math
    in another sum order) from a mid-clip state, over 4 steps."""
    cfg, w, tp, state = _state64(n_fft, hop, la)
    lit, coms = state, []
    for i in range(4):
        lit, com = trt._frame_step(lit, tp[:, i : i + la + 1], w, LR, cfg, la, asym, 3)
        coms.append(com)
    windows = trt.rtisi_windows(w, cfg, asym)
    twin = twins.rtisi_steps_twin(*state, tp[:, : 4 + la], windows, LR, cfg, 3)
    for o, r in zip(twin, (torch.stack(coms), *lit)):
        assert o.shape == r.shape
        scale = float(r.abs().max()) if r.numel() else 1.0
        torch.testing.assert_close(o, r, rtol=0, atol=1e-10 * scale)


def test_steps_chain_is_bitwise_in_k():
    """One call of k steps equals k calls of one step, bit for bit."""
    cfg, w, tp, state = _state64(512, 128, 3)
    windows = trt.rtisi_windows(w, cfg, False)
    com, *whole = rtisi_fused.fused_rtisi_steps(*state, tp[:, :9], windows, LR, cfg, 2)
    st, coms = tuple(state), []
    for i in range(6):
        c, *st = rtisi_fused.fused_rtisi_steps(*st, tp[:, i : i + 4], windows, LR, cfg, 2)
        coms.append(c)
    assert torch.equal(com, torch.cat(coms))
    assert all(torch.equal(a, b) for a, b in zip(whole, st))


def test_autograd_function_replays_twin(monkeypatch):
    """The autograd.Function around the kernel: forward from the launch,
    backward from the plain twin.  With the launch swapped for its plain
    version on the CPU, its gradients equal plain autograd's."""
    cfg, w, tp, state = _state64(256, 64, 2, steps=3)
    windows = trt.rtisi_windows(w, cfg, True)
    tgt = tp[:, :5].clone().requires_grad_(True)
    upd = state.update.clone().requires_grad_(True)

    def loss(out):
        com, keep, u, pre = out
        return (com ** 2).sum() + (keep ** 2).sum() + (u ** 2).sum() + (pre.abs() ** 2).sum()

    g_plain = torch.autograd.grad(loss(rtisi_fused.fused_rtisi_steps_reference(
        state.keeped, upd, state.pre_spec, tgt, windows, LR, cfg, 2)), (upd, tgt))
    monkeypatch.setattr(rtisi_fused, "_launch", rtisi_fused.fused_rtisi_steps_reference)
    out = rtisi_fused._RTISISteps.apply(state.keeped, upd, state.pre_spec, tgt, *windows, LR,
                                         cfg, 2)
    g_fn = torch.autograd.grad(loss(out), (upd, tgt))
    for a, b in zip(g_fn, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=0)


def test_supports_and_checks():
    cfg, w = tcanon(1025, np.float32, hop_length=512)
    win = torch.from_numpy(w)
    assert rtisi_fused.supports(cfg, win)
    whisper, ww = tcanon(201, np.float32, hop_length=160)  # n_fft 400: n/2 = 2^3 5^2
    assert rtisi_fused.supports(whisper, torch.from_numpy(ww))
    for bins, kw in ((442, dict(hop_length=220)), (1025, dict(hop_length=4096)),
                     (4097, {}), (1024, dict(onesided=False))):
        c, wc = tcanon(bins, np.float32, **kw)
        assert not rtisi_fused.supports(c, torch.from_numpy(wc))
    assert not rtisi_fused.supports(cfg, win.to(torch.complex64))
    windows = trt.rtisi_windows(win, cfg, False)
    good = (torch.zeros(2, 3, 2048), torch.zeros(2, 4, 2048),
            torch.zeros(2, 4, 1025, dtype=torch.complex64), torch.zeros(2, 11, 1025))
    rtisi_fused._check(*good, windows, cfg)
    for i, bad in enumerate((torch.zeros(2, 2, 2048), torch.zeros(2, 4, 2048, dtype=torch.float64),
                             torch.zeros(2, 4, 1025), torch.zeros(2, 3, 1025))):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            rtisi_fused._check(*args, windows, cfg)


@pytest.mark.parametrize("n_fft", [16, 32, 64, 128, 256, 400, 512, 1024, 1200, 2048, 4096])
def test_launch_plan_covers_every_admitted_shape(n_fft):
    """The kernel's launch plan for every hop (powers of two up to n_fft)
    and every count R of in-flight frames up to n_fft / hop: each CTA owns
    one or more frames and each frame exactly one CTA, the cluster stays
    within the portable 8, shared memory within the 227 KB a block can take
    and equal to the kernel's layout (FP64 twiddles, the synthesis window,
    two skewed FP64 FFT buffers per frame of a pass, and the state where it
    is resident: a replica of every frame's upd and the owned frames' other
    state), and
    state that does not fit goes to a device scratch big enough for it."""
    half = n_fft // 2
    frame_floats = 3 * n_fft + 3 * (half + 1)  # per frame in device memory
    hop = 1
    while hop <= n_fft:
        for R in range(1, n_fft // hop + 1):
            p = rtisi_fused.plan(n_fft, R)
            assert 1 <= p.cluster <= 8 and p.frames_per_cta >= 1
            owners = np.zeros(R, dtype=int)
            for rank in range(p.cluster):
                owned = p.owned(rank, R)
                assert len(owned) >= 1
                owners[owned.start : owned.stop] += 1
            assert (owners == 1).all()
            assert 1 <= p.group <= p.frames_per_cta
            assert 32 <= p.threads <= 512 and p.threads % 32 == 0
            assert half <= 4 * p.threads  # the gather's four sample pairs per thread
            smem = 16 * half + 4 * n_fft + 32 * p.group * (half + half // 8)
            # in shared memory: a replica of every frame's upd (two buffers)
            # and the owned frames' committed tail, momentum and target row
            resident = 4 * (2 * R * n_fft + p.frames_per_cta * (n_fft + 3 * (half + 1)))
            if p.resident:
                smem += resident
                assert p.scratch == 0
            else:
                assert p.scratch >= R * frame_floats and p.scratch % 2 == 0
                # resident only if the whole state and one FFT pass fit
                assert smem + resident - 32 * (p.group - 1) * (
                    half + half // 8) > rtisi_fused.SHARED_BYTES
            assert p.smem == smem <= rtisi_fused.SHARED_BYTES
        hop *= 2
    with pytest.raises(ValueError):
        rtisi_fused.plan(n_fft, 0)


def test_chip_smoke_check_states(tmp_path, monkeypatch):
    """The RTISI check states chip_smoke.py starts from: the digest it
    checks, finite values, and the layout (keeped, update, pre) of config 3
    at batch 1 and 16 and of each small geometry at batch 2; a file with
    other contents is refused."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    states = cs.rtisi_check_states(torch.device("cpu"))
    layout = {"cfg3_b1": (1, 2048, 512, None), "cfg3_b16": (16, 2048, 512, None)}
    layout.update({f"small{i}": (2, n, hop, extra.get("look_ahead"))
                   for i, (n, hop, extra) in enumerate(cs.RTISI_SMALL)})
    assert set(states) == set(layout)
    for name, (batch, n, hop, la) in layout.items():
        nk = (n - 1) // hop
        R = (nk if la is None else la) + 1
        keep, upd, pre = states[name]
        assert keep.shape == (batch, nk, n) and keep.dtype == torch.float32
        assert upd.shape == (batch, R, n) and upd.dtype == torch.float32
        assert pre.shape == (batch, R, n // 2 + 1) and pre.dtype == torch.complex64
        assert all(bool(torch.isfinite(t).all()) for t in (keep, upd, pre))
    altered = tmp_path / "states.npz"
    altered.write_bytes(cs.RTISI_STATES.read_bytes() + b"\0")
    monkeypatch.setattr(cs, "RTISI_STATES", altered)
    with pytest.raises(AssertionError, match="unexpected contents"):
        cs.rtisi_check_states(torch.device("cpu"))
