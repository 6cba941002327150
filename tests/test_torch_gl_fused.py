"""The module that holds the direct-DFT Griffin-Lim kernel, on the CPU, and
the slice's path griffin_lim(backend='dft') as a whole.

The port's fused_gl_iteration takes its plain version for CPU tensors; it is
held against the JAX kernel gl_fused.fused_gl_iteration run in Pallas
interpret mode, from one state carried across by convert.dft_state_from_jax:
n_fft 512, hop 128, B=2, 61 frames of white noise, a random-phase momentum
plane, 1 and 3 chained iterations, in every tier JAX computes as written on
the CPU (HIGH, 'bf16x2', 'bf16x2t', HIGHEST and a (HIGH, 'bf16x2') pair) and
in every pad mode, with center=False and with normalized=True.

Tolerances, relative to the largest value of the JAX output, come from a
float64 run of the port's plain version with the same splits (the anchor):
each is twice the largest sum, over these cases, of the JAX kernel's and the
port's float32 distance from the anchor, rounded up to one digit.  Measured
(JAX / port, worst case): after 1 iteration x 7.9e-6 / 8.2e-6 under HIGH,
1.5e-4 / 1.5e-4 under the pair; after 3, x 1.4e-5 / 1.4e-5, |S| 3.8e-5 /
4.5e-5 and the momentum 4.1e-5 / 8.0e-5 under HIGH.  The 2-pass tier that drops the
data's low half ('bf16x2' in the inverse) rounds P to bf16, so where the two
float32 sides differ by an ulp a bin can round to the neighbouring bf16
value: after 3 iterations x lies up to 5.7e-3 from the anchor there, and its
limits are wide.  The DEFAULT tier (one bf16 pass) is held against numpy: the
same iteration in float64 on bf16-rounded operands.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu.config import canonicalize as jcanon
from specinv_tpu.models._pallas_driver import make_geometry, make_inv_env, pad_tf
from specinv_tpu.ops import stft as jst
from specinv_tpu.ops.framing import pad_center as j_pad_center
from specinv_tpu.ops.pallas import gl_fused as j_gl_fused
from specinv_tpu_torch import convert
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.models import common
from specinv_tpu_torch.ops import dft, fourier, twins
from specinv_tpu_torch.ops.cuda import _dft, gl_fused
from specinv_tpu_torch.ops.framing import pad_center
from specinv_tpu_torch.ops.stft import istft
from specinv_tpu_torch.utils import runner

from specinv_tpu_torch.utils.corpus import make_speech_like

from .helpers import torch_stft

tgl = importlib.import_module("specinv_tpu_torch.models.griffin_lim")

N_FFT, HOP, B, LR = 512, 128, 2, 0.5
HIGH, HIGHEST = jax.lax.Precision.HIGH, jax.lax.Precision.HIGHEST

# JAX precision, the port's, and the limits {iterations: (x, |S|, momentum)}
TIERS = {
    "high": (HIGH, "high", {1: (4e-5, 4e-6, 4e-6), 3: (6e-5, 2e-4, 3e-4)}),
    "bf16x2": ("bf16x2", "bf16x2", {1: (3e-4, 2e-6, 9e-7), 3: (2e-2, 2e-2, 3e-2)}),
    "bf16x2t": ("bf16x2t", "bf16x2t", {1: (4e-5, 4e-6, 4e-6), 3: (2e-4, 3e-4, 5e-4)}),
    "highest": (HIGHEST, "highest", {1: (5e-6, 3e-6, 3e-6), 3: (2e-5, 4e-5, 8e-5)}),
    "pair": ((HIGH, "bf16x2"), ("high", "bf16x2"), {1: (7e-4, 4e-6, 4e-6),
                                                    3: (3e-3, 6e-3, 7e-3)}),
}
CASES = {
    "reflect": {}, "constant": dict(pad_mode="constant"),
    "replicate": dict(pad_mode="replicate"), "circular": dict(pad_mode="circular"),
    "center_false": dict(center=False), "normalized": dict(normalized=True),
}


def _setup(extra, seed=7):
    """One starting state in both layouts: ``(jc, tc, w, T, geo, jax_state,
    port_inputs)`` with ``jax_state = (x0, re, im, target_pad, inv_env)``
    and ``port_inputs = (x_pad, plane, target, window, inv_env)``."""
    rng = np.random.default_rng(seed)
    win = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    kw = dict(window=win, hop_length=HOP, **extra)
    jc, w = jcanon(N_FFT // 2 + 1, np.float32, **kw)
    tc, _ = tcanon(N_FFT // 2 + 1, np.float32, **kw)
    clips = rng.standard_normal((B, 7800 if jc.center else 8300)).astype(np.float32)
    spec = np.asarray(jst.stft(jnp.asarray(clips), jc, jnp.asarray(w)))
    T, F = spec.shape[-2:]
    mag = np.abs(spec).astype(np.float32)
    seed_spec = (mag * np.exp(1j * rng.uniform(0, 2 * np.pi, spec.shape))).astype(np.complex64)
    geo = make_geometry(jc, T, F)
    j_env = make_inv_env(jc, jnp.asarray(w), T, geo)
    x0 = j_pad_center(jst.istft(jnp.asarray(seed_spec), jc, jnp.asarray(w)), jc)
    x0 = jnp.pad(x0, ((0, 0), (0, geo.lx - geo.lp))).astype(jnp.float32)
    tp = pad_tf(jnp.asarray(mag), geo, T, F)
    re, im = pad_tf(jnp.asarray(seed_spec.real), geo, T, F), pad_tf(jnp.asarray(seed_spec.imag),
                                                                   geo, T, F)
    x, plane, tgt = convert.dft_state_from_jax(x0, re, im, tp, N_FFT, T)
    tgeo = twins.make_geometry(tc, T)
    assert x.shape[-1] == tgeo.lp and plane.shape == (B, T, F)
    win_t = torch.from_numpy(w)
    port = (torch.from_numpy(np.array(x)), torch.from_numpy(plane),
            torch.from_numpy(np.array(tgt)), win_t, twins.make_inv_env(tc, win_t, T, tgeo))
    return jc, tc, w, T, geo, (x0, re, im, tp, j_env), port


def _close(ours, ref, limit, what):
    ours, ref = np.asarray(ours), np.asarray(ref)
    if np.iscomplexobj(ref):
        ours = np.concatenate([ours.real, ours.imag])
        ref = np.concatenate([ref.real, ref.imag])
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= limit, f"{what}: {err:.3e} > {limit:.0e}"


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_iteration_matches_jax_kernel(tier, case):
    jprec, tprec, limits = TIERS[tier]
    jc, tc, w, T, geo, (jx, jre, jim, tp, j_env), (x, pre, tgt, win, env) = _setup(CASES[case])
    for it in (1, 2, 3):
        jx, jmag, jre, jim = j_gl_fused.fused_gl_iteration(
            jx, jre, jim, tp, jnp.asarray(w), j_env, jnp.float32(LR), jc, geo.e,
            block_t=geo.block_t, interpret=True, precision=jprec)
        x, mag, pre = gl_fused.fused_gl_iteration(x, pre, tgt, win, env, LR, tc, tprec)
        if it in limits:
            rx, rpre, rmag = convert.dft_state_from_jax(jx, jre, jim, jmag, N_FFT, T)
            lx, lmag, lpre = limits[it]
            _close(x.numpy(), rx, lx, f"x after {it}")
            _close(mag.numpy(), rmag, lmag, f"|S| after {it}")
            _close(pre.numpy(), rpre, lpre, f"momentum after {it}")


def _bf16(a):
    """Round float32 to the nearest bf16 (ties to even), kept as float64."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def numpy_default_iteration(x_pad, plane, target, window, inv_env, scalar, cfg, geo, admm=False,
                            valid_t=None):
    """One iteration of the DEFAULT tier in numpy: every product of the two
    DFTs takes bf16-rounded operands and sums in float64; the rest is
    float64.  ``admm`` switches the middle to the DR-ADMM update."""
    n, hop = cfg.n_fft, cfg.hop_length
    cos, sin, w = (a.astype(np.float64) for a in dft.dft_tables(n, cfg.normalized))
    T = target.shape[-2]
    idx = np.arange(T)[:, None] * hop + np.arange(n)[None, :]
    frames = (x_pad[:, idx].astype(np.float32) * window.astype(np.float32)).astype(np.float32)
    fb = _bf16(frames)
    s = fb @ _bf16(cos) - 1j * (fb @ _bf16(sin))
    mag = np.abs(s)
    if admm:
        z = (scalar * plane + s) / (1.0 + scalar)
        u = plane - z
        t = z - u
        state = t * (target / (np.abs(t) + 1e-16)) + u
        state[:, valid_t:] = 0
        p = state * w
    else:
        state = s - scalar * plane
        p = state * (target / (np.abs(state) + 1e-16) * w)
    fr = (_bf16(p.real.astype(np.float32)) @ _bf16(cos).T
          - _bf16(p.imag.astype(np.float32)) @ _bf16(sin).T) * window
    y = np.zeros_like(x_pad, dtype=np.float64)
    for t in range(T):
        y[:, t * hop : t * hop + n] += fr[:, t]
    y = torch.from_numpy(y * inv_env)
    return twins.repad_edges(y, cfg, geo).numpy(), mag, state


def test_default_tier_matches_numpy_one_bf16_pass():
    """One bf16 pass (the port's DEFAULT; JAX computes DEFAULT in float32 on
    the CPU, so numpy is the reference).  Both sides round the same float32
    operands to bf16; P is float32 on the port's side and float64 in numpy,
    so a bin may round to the neighbouring bf16 value: x within 2e-4 of the
    max (measured 5e-5 worst over the pad modes), |S| and the momentum
    within 1e-5."""
    for case in ("reflect", "circular", "normalized"):
        _, tc, _, T, _, _, (x, pre, tgt, win, env) = _setup(CASES[case])
        ox, omag, opre = gl_fused.fused_gl_iteration(x, pre, tgt, win, env, LR, tc, "default")
        geo = twins.make_geometry(tc, T)
        rx, rmag, rpre = numpy_default_iteration(
            x.numpy(), pre.numpy().astype(np.complex128), tgt.numpy().astype(np.float64),
            win.numpy().astype(np.float64), env.numpy().astype(np.float64), LR, tc, geo)
        _close(ox.numpy(), rx, 2e-4, f"{case} x")
        _close(omag.numpy(), rmag, 1e-5, f"{case} |S|")
        _close(opre.numpy(), rpre, 1e-5, f"{case} momentum")


def test_tables_match_jax():
    for n_fft, normalized in ((512, False), (512, True), (400, False), (2048, False)):
        cos, sin, w = dft.dft_tables(n_fft, normalized)
        f = n_fft // 2 + 1
        jcos, jsin, jw = j_gl_fused._dft_tables(n_fft, -(-f // 128) * 128, normalized)
        np.testing.assert_array_equal(cos, jcos[:, :f])
        np.testing.assert_array_equal(sin, jsin[:, :f])
        np.testing.assert_array_equal(w, jw[0, :f])


@pytest.mark.parametrize("n_fft,normalized", [(16, False), (400, False), (500, True),
                                               (1000, False), (2048, False), (4096, True)])
def test_interleaved_tables_hold_the_jax_tables_and_zero_padding(n_fft, normalized):
    """The split kernels' table layout (ops/cuda/_dft.interleaved_tables):
    the JAX tables' cos at [k, 2f] and -sin at [k, 2f + 1] of M2 (n_pad, 2
    f_pad), zeros elsewhere, and the forward's operand its transpose; their
    bf16 halves are the split of the float32 values."""
    cos, sin, _ = dft.dft_tables(n_fft, normalized)
    f = n_fft // 2 + 1
    jcos, jsin, _ = j_gl_fused._dft_tables(n_fft, -(-f // 128) * 128, normalized)
    fwd, inv = _dft.interleaved_tables(n_fft, normalized)
    n_pad, f_pad = _dft.padded_sizes(n_fft)
    assert n_pad % 64 == 0 and n_pad - 64 < n_fft <= n_pad
    assert f_pad % 32 == 0 and f_pad - 32 < f <= f_pad
    assert inv.shape == (n_pad, 2 * f_pad) and inv.dtype == torch.float32
    assert torch.equal(fwd, inv.t())
    np.testing.assert_array_equal(inv[:n_fft, 0 : 2 * f : 2].numpy(), jcos[:, :f])
    np.testing.assert_array_equal(inv[:n_fft, 1 : 2 * f : 2].numpy(), -jsin[:, :f])
    np.testing.assert_array_equal(inv[:n_fft, 1 : 2 * f : 2].numpy(), -sin)
    np.testing.assert_array_equal(inv[:n_fft, 0 : 2 * f : 2].numpy(), cos)
    assert not inv[n_fft:].any() and not inv[:, 2 * f :].any()
    hi, lo = dft.split_bf16(inv[:n_fft, : 2 * f])
    chi, clo = dft.split_bf16(torch.from_numpy(np.array(cos)))
    shi, slo = dft.split_bf16(torch.from_numpy(np.array(sin)))
    assert torch.equal(hi[:, 0::2], chi) and torch.equal(lo[:, 0::2], clo)
    assert torch.equal(hi[:, 1::2], -shi) and torch.equal(lo[:, 1::2], -slo)



@pytest.mark.parametrize("n_fft,hop,normalized", [(400, 160, False), (500, 125, True),
                                                  (2048, 512, False)])
def test_highest_operands_are_the_interleaved_float32_tables(n_fft, hop, normalized):
    """What the 'highest' tier of the kernels reads: the device tables'
    float32 ``fwd`` / ``inv`` (here on the CPU) are interleaved_tables' (cos
    at [k, 2f], -sin at [k, 2f + 1], zeros in the pad), the fold weights
    dft_tables'; the framed signal zero-padded to n_pad (B, T, n_pad) times
    M2 gives the forward of scheme_matmul(..., 'highest') in its
    interleaved columns, and P interleaved and zero-padded (B, T, 2 f_pad)
    times M2^T the inverse, to float32 rounding (only the order of the sums
    differs), with exact zeros in the pad columns of the forward."""
    cos, sin, w = (torch.from_numpy(np.array(a)) for a in dft.dft_tables(n_fft, normalized))
    tab = _dft.device_tables(n_fft, normalized, torch.device("cpu"))
    fwd, inv = _dft.interleaved_tables(n_fft, normalized)
    assert torch.equal(tab.fwd, fwd) and torch.equal(tab.inv, inv) and torch.equal(tab.w, w)
    assert tab.fwd.dtype == tab.inv.dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(tab[3:], (*dft.split_bf16(fwd),
                                                           *dft.split_bf16(inv))))
    n_pad, f_pad = _dft.padded_sizes(n_fft)
    f = n_fft // 2 + 1
    rng = np.random.default_rng(n_fft)
    x = torch.from_numpy(rng.standard_normal((2, 8 * hop + n_fft)).astype(np.float32))
    win = torch.hann_window(n_fft)
    frames = x.unfold(-1, n_fft, hop) * win  # (B, T, n)
    padded = torch.nn.functional.pad(frames, (0, n_pad - n_fft))
    s = padded @ inv  # (B, T, 2 f_pad)
    top = float(s.abs().max())
    ref_re = dft.scheme_matmul(frames, cos, "highest")
    ref_im = -dft.scheme_matmul(frames, sin, "highest")
    assert float((s[..., 0 : 2 * f : 2] - ref_re).abs().max()) <= 1e-6 * top
    assert float((s[..., 1 : 2 * f : 2] - ref_im).abs().max()) <= 1e-6 * top
    assert not s[..., 2 * f :].any()
    p = torch.complex(*(torch.from_numpy(rng.standard_normal((2, 9, f)).astype(np.float32))
                        for _ in range(2)))
    planes = torch.nn.functional.pad(torch.view_as_real(p).flatten(-2), (0, 2 * (f_pad - f)))
    y = (planes @ fwd)[..., :n_fft]
    ref = (dft.scheme_matmul(p.real, cos.T, "highest")
           - dft.scheme_matmul(p.imag, sin.T, "highest"))
    assert float((y - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert not (planes @ fwd)[..., n_fft:].any()

def test_split_and_schemes_match_jax():
    """The bf16 split and the product schemes against JAX's own, bitwise on
    the halves, to float32 rounding on the products."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, 40)).astype(np.float32)
    b = rng.standard_normal((40, 9)).astype(np.float32)
    hi, lo = dft.split_bf16(torch.from_numpy(a))
    jhi, jlo = j_gl_fused._split_bf16(jnp.asarray(a))
    np.testing.assert_array_equal(hi.float().numpy(), np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.float().numpy(), np.asarray(jlo.astype(jnp.float32)))
    contract = (((1,), (0,)), ((), ()))
    for jp, tp in ((HIGH, "high"), ("bf16x2", "bf16x2"), ("bf16x2t", "bf16x2t"),
                   (HIGHEST, "highest")):
        ref = np.asarray(j_gl_fused._dot3(jnp.asarray(a), jnp.asarray(b), contract, jp))
        ours = dft.scheme_matmul(torch.from_numpy(a), torch.from_numpy(b), tp).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert dft.needs_lo("high") and dft.needs_lo("bf16x2t") and not dft.needs_lo("bf16x2")
    assert dft.split_schemes(("high", "bf16x2")) == ("high", "bf16x2")
    assert dft.split_schemes("high") == ("high", "high")


def _spec_pair(batch=2, n_samples=8000):
    """A complex64 spectrogram of speech-like clips (utils/corpus), phase-
    seeded in float64, for both packages (the float32 SPSI seed sums in
    another order in XLA and torch)."""
    x = np.stack([make_speech_like(n_samples, seed=s) for s in range(batch)])
    win = np.hanning(N_FFT + 1)[:-1]
    mag = np.abs(torch_stft(x, N_FFT, hop_length=HOP, window=win))
    spec = np.asarray(si.phase_init(mag, hop_length=HOP, window=win)).astype(np.complex64)
    return spec, win.astype(np.float32)


@pytest.mark.parametrize("kw,limit", [
    (dict(max_iter=6, tol=0.0), 2e-4),
    (dict(max_iter=40, tol=1.0, eva_iter=5), 3e-4),
    (dict(max_iter=6, tol=0.0, precision="highest"), 3e-5),
], ids=["tol0", "early_stop", "highest"])
def test_dft_backend_matches_jax_pallas(kw, limit):
    """griffin_lim(backend='dft') against the JAX backend='pallas' (interpret
    mode on the CPU) from the same complex seed, relative to the largest
    sample.  Limits: twice the sum of both sides' distance from a float64
    run of the 'fft' path (exact DFTs), which after 6 iterations under HIGH
    is 3.9e-5 (JAX) and 3.6e-5 (port), with early stopping (40 iterations
    of eval_iter 5) 5.8e-5 and 5.2e-5, and under HIGHEST 5.1e-6 and
    6.8e-6."""
    spec, win = _spec_pair()
    jkw = dict(kw, hop_length=HOP, window=win, verbose=False)
    jkw["precision"] = HIGHEST if kw.get("precision") == "highest" else HIGH
    ref = np.asarray(si.griffin_lim(spec, backend="pallas", **jkw))
    ours = st.griffin_lim(torch.from_numpy(spec), backend="dft",
                          **dict(jkw, precision=kw.get("precision")))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=limit * np.abs(ref).max(), rtol=0)


def test_dft_modes_agree_and_early_stop_freezes():
    spec, win = _spec_pair(1)
    kw = dict(max_iter=60, tol=1.0, eva_iter=5, verbose=False, hop_length=HOP, window=win)
    mag = torch.from_numpy(np.abs(spec))
    a = st.griffin_lim(mag, mode="fori", backend="dft", **kw)
    b = st.griffin_lim(mag, mode="while", backend="dft", **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the stop fires at the second eval: 10 iterations, not 60
    c = st.griffin_lim(mag, backend="dft", **dict(kw, max_iter=10, tol=0.0))
    torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("tol", [1.0, 1e-12])
def test_dft_fori_selects_once_per_evaluation(tol):
    """'fori' selects the kept state at evaluations only (utils/runner):
    at most one select per evaluation plus one, and the 'while' result, with
    the stop firing (tol 1.0) or not."""
    spec, win = _spec_pair(1)
    kw = dict(max_iter=40, tol=tol, eva_iter=10, verbose=False, hop_length=HOP, window=win,
              backend="dft")
    mag = torch.from_numpy(np.abs(spec))
    before = runner.state_selects
    a = st.griffin_lim(mag, mode="fori", **kw)
    assert runner.state_selects - before <= 40 // 10 + 1
    torch.testing.assert_close(a, st.griffin_lim(mag, mode="while", **kw), rtol=0, atol=0)


def test_dft_default_precision_knob():
    spec, win = _spec_pair(1)
    kw = dict(max_iter=3, tol=0.0, verbose=False, hop_length=HOP, window=win, backend="dft")
    mag = torch.from_numpy(np.abs(spec))
    assert fourier.default_precision() == "high"
    high = st.griffin_lim(mag, **kw)
    torch.testing.assert_close(st.griffin_lim(mag, precision="high", **kw), high, rtol=0, atol=0)
    try:
        fourier.set_default_precision("HIGHEST")
        assert fourier.default_precision() == "highest"
        torch.testing.assert_close(st.griffin_lim(mag, **kw),
                                   st.griffin_lim(mag, precision="highest", **kw), rtol=0, atol=0)
    finally:
        fourier.set_default_precision("high")
    with pytest.raises(ValueError):
        fourier.set_default_precision("bf16x2")


def test_iteration_gradient_is_the_highest_twin():
    """The gradient of one iteration at any tier is the plain twin's at
    'highest' from the same inputs (the JAX custom_vjp's rule for scheme
    strings)."""
    _, tc, _, T, _, _, (x, pre, tgt, win, env) = _setup({})
    geo = twins.make_geometry(tc, T)
    rng = np.random.default_rng(1)
    cx = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    cp = torch.from_numpy(rng.standard_normal(pre.shape).astype(np.complex64))

    def loss(xo, po):  # linear: its gradient does not depend on the forward values
        return (xo * cx).sum() + (po * cp).real.sum()

    grads = []
    for run in ("kernel_wrapper", "twin"):
        x0 = x.clone().requires_grad_(True)
        t0 = tgt.clone().requires_grad_(True)
        if run == "twin":
            (xo, po), _ = twins.gl_dft_twin((x0, pre), t0, win, env, LR, tc, geo, "highest")
        else:
            xo, _mag, po = gl_fused.fused_gl_iteration(x0, pre, t0, win, env, LR, tc, "bf16x2")
        grads.append(torch.autograd.grad(loss(xo, po), (x0, t0)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def _twin_vjp_case(extra=None):
    """The JAX state of :func:`_setup` in float64, a random cotangent on its
    real region (zero on the padded rows, lanes and samples), and the port's
    inputs in float64."""
    jc, tc, w, T, geo, (x0, re, im, tp, _), port = _setup(extra or {})
    f64 = jnp.float64
    jstate = (jnp.asarray(x0, f64), jnp.asarray(re, f64), jnp.asarray(im, f64))
    j_env = make_inv_env(jc, jnp.asarray(w, f64), T, geo)
    lp, F = twins.make_geometry(tc, T).lp, N_FFT // 2 + 1
    rng = np.random.default_rng(5)
    cx = np.zeros(x0.shape)
    cx[:, :lp] = rng.standard_normal((B, lp))
    cp = np.zeros((2,) + tuple(tp.shape))
    cp[:, :, :T, :F] = rng.standard_normal((2, B, T, F))
    x, plane, tgt, win, _ = (t.to(torch.complex128 if t.is_complex() else torch.float64)
                             for t in port)
    env = twins.make_inv_env(tc, win, T, twins.make_geometry(tc, T))  # in float64, as j_env
    return jc, tc, w, T, geo, jstate, jnp.asarray(tp, f64), j_env, (cx, cp), (x, plane, tgt,
                                                                              win, env)


def test_twin_vjp_matches_jax_twin_f64():
    """The backward of one iteration, the port's gl_dft_twin at 'highest',
    against the JAX backward rule, jax.vjp of gl_xla_twin at HIGHEST, in
    float64 from the same state and cotangent: gradients with respect to the
    signal and the target within 1e-7 of their largest entry (float64
    rounding, amplified where |S| is small; measured 5.5e-9)."""
    from specinv_tpu.models._pallas_driver import gl_xla_twin

    jc, tc, w, T, geo, jstate, jtp, j_env, (cx, cp), (x, pre, tgt, win, env) = _twin_vjp_case()
    _, vjp = jax.vjp(lambda s, t: gl_xla_twin(s, t, jnp.asarray(w, jnp.float64), j_env, LR, jc,
                                              geo, HIGHEST)[0], jstate, jtp)
    (jgx, _, _), jgt = vjp((jnp.asarray(cx), jnp.asarray(cp[0]), jnp.asarray(cp[1])))
    x.requires_grad_(True)
    tgt.requires_grad_(True)
    (xo, po), _ = twins.gl_dft_twin((x, pre), tgt, win, env, LR, tc, twins.make_geometry(tc, T),
                                 "highest")
    lp, F = x.shape[-1], tgt.shape[-1]
    cpt = torch.complex(*(torch.from_numpy(c[:, :T, :F]) for c in cp))
    gx, gt = torch.autograd.grad((xo, po), (x, tgt), (torch.from_numpy(cx[:, :lp]), cpt))
    _close(gx.numpy(), np.asarray(jgx)[:, :lp], 1e-7, "d/dx")
    _close(gt.numpy(), np.asarray(jgt)[:, :T, :F], 1e-7, "d/dtarget")


def test_dft_path_gradient_is_the_highest_twin_chain():
    """A gradient through griffin_lim's 'dft' path (run_tm_dft, 3 iterations
    at 'highest') equals plain autograd through 3 calls of the twin: the
    backward of every iteration is the twin at 'highest'.  (Across packages
    the gradient with respect to the magnitude is ill-conditioned in float32,
    through 1/|S| at small bins and the SPSI seed, so the cross-package check
    is test_twin_vjp_matches_jax_twin_f64.)"""
    _, tc, _, T, _, _, (_, pre, tgt, win, _) = _setup({})
    c = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, twins.make_geometry(tc, T).l_out)).astype(np.float32))
    grads = []
    for how in ("path", "twin"):
        t = tgt.clone().requires_grad_(True)
        if how == "path":
            y = tgl.run_tm_dft(t, pre, win, LR, 0.0, tc, max_iter=3, precision="highest")
        else:
            geo = twins.make_geometry(tc, T)
            env = twins.make_inv_env(tc, win, T, geo)
            state = (pad_center(istft(pre, tc, win), tc), pre)
            for _ in range(3):
                state, _mag = twins.gl_dft_twin(state, t, win, env, LR, tc, geo, "highest")
            y = state[0][..., geo.p_amt : geo.p_amt + geo.l_out]
        grads.append(torch.autograd.grad((y * c).sum(), t)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6 * float(grads[1].abs().max()))


def test_supports_both_sides():
    win = torch.hann_window(2048)
    cfg, _ = tcanon(1025, np.float32, hop_length=512)
    assert _dft.supports(cfg, win) and gl_fused.supports(cfg, win)
    for bins, hop in ((201, 160), (257, 160), (513, 240), (2049, 1)):  # C7, n_fft 4096
        c, _ = tcanon(bins, np.float32, hop_length=hop)
        assert _dft.supports(c, torch.ones(c.n_fft)), (bins, hop)
    big = tcanon(4097, np.float32, hop_length=1024)[0]  # n_fft 8192
    assert not _dft.supports(big, torch.ones(big.n_fft))
    c = tcanon(201, np.float32, hop_length=401)[0]  # hop > n_fft
    assert not _dft.supports(c, torch.ones(400))
    assert not _dft.supports(dataclasses.replace(c, hop_length=0), torch.ones(400))
    assert not _dft.supports(cfg, win.to(torch.complex64))
    two, _ = tcanon(400, np.float32, hop_length=160, onesided=False)
    assert not _dft.supports(two, torch.ones(400))
    with pytest.raises(ValueError, match="dft backend needs"):
        common.resolve_backend("dft", two, torch.ones(400), torch.device("cuda"))


def test_resolve_backend_and_precision_rules():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    c7, w7 = tcanon(201, np.float32, hop_length=160)
    assert common.resolve_backend("auto", c7, torch.from_numpy(w7), cuda) == "dft"
    assert common.resolve_backend("auto", c7, torch.from_numpy(w7), cuda, is_complex=True) == "fft"
    assert common.resolve_backend("auto", c7, torch.from_numpy(w7), cpu) == "fft"
    two, w2 = tcanon(400, np.float32, hop_length=160, onesided=False)
    assert common.resolve_backend("auto", two, torch.from_numpy(w2), cuda) == "fft"
    cwin = np.hanning(401)[:-1].astype(np.complex64)
    cc, wc = tcanon(400, np.float32, hop_length=160, window=cwin)
    assert common.resolve_backend("auto", cc, torch.from_numpy(wc), cuda) == "fft"
    cfg1, w1 = tcanon(1025, np.float32, hop_length=512)
    assert common.resolve_backend("auto", cfg1, torch.from_numpy(w1), cuda) == "kernel"
    assert common.resolve_backend("dft", cfg1, torch.from_numpy(w1), cpu) == "dft"
    for bad in ("pallas", "pallas4"):
        with pytest.raises(ValueError, match="'dft'.*'kernel'"):
            common.resolve_backend(bad, cfg1, torch.from_numpy(w1), cuda)
    # precision: every tier and pairs on 'dft'; float32 tiers elsewhere
    assert dft.check_precision(None, "dft") == "high"
    assert dft.check_precision("BF16X2T", "dft") == "bf16x2t"
    assert dft.check_precision(("HIGH", "bf16x2"), "dft") == ("high", "bf16x2")
    for p in (None, "high", "highest"):
        for backend in ("kernel", "fft"):
            assert dft.check_precision(p, backend) == p
    assert dft.check_precision("default", "fft") == "default"  # JAX's XLA rule; no effect
    for backend, bad in (("kernel", "bf16x2"), ("kernel", "default"), ("fft", "bf16x2"),
                         ("fft", ("high", "high")),
                         ("dft", "tf32"), ("dft", ("high",)), ("dft", ("high", "x"))):
        with pytest.raises(ValueError):
            dft.check_precision(bad, backend)
    mag = torch.rand(257, 20)
    with pytest.raises(ValueError):
        st.griffin_lim(mag, max_iter=2, verbose=False, precision="bf16x2")   # CPU auto: fft
    assert st.griffin_lim(mag, max_iter=2, verbose=False, backend="dft",
                          precision=("high", "bf16x2")).shape[-1] > 0
