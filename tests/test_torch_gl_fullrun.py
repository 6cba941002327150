"""The module that holds the whole-run Griffin-Lim kernel, on the CPU.

The port's fused_gl_run takes its plain version for CPU tensors; it is held
against the JAX driver gl_fullrun4.fused_gl_run run in Pallas interpret mode
at precision=HIGHEST, on the same state carried across by
convert.state_from_jax.  n_fft 512, hop 128, B=2, 60 frames, 5 iterations
(as tests/test_pallas.py), every pad mode and center=False.  With lane=False,
and with hop 384 (which does not divide n_fft) by default, the JAX driver
dispatches to gl_fullrun4._kernel, the (m, 128)-layout whole-run kernel: the
port's one Griffin-Lim kernel stands in for that dispatch too.

Tolerances (float32 on both sides): x atol 5e-5 relative to its max, the
band of the JAX package's own HIGHEST-vs-XLA check; the eval sums rtol 1e-5.
The state and magnitude planes carry absolute error only: after 5
iterations each float32 side is 2.5e-5 (port) and 4.2e-5 (JAX) of the
plane's max away from a float64 run of the same math, so they are held at
atol 1e-4 of the max (about twice the larger of the two) with rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specinv_tpu.config import canonicalize as jcanon
from specinv_tpu.models._pallas_driver import make_geometry4
from specinv_tpu.models._pallas_driver import make_inv_env as j_make_inv_env
from specinv_tpu.ops import stft as jst
from specinv_tpu.ops.pallas import fft4
from specinv_tpu.ops.pallas import fullrun_lane, gl_fullrun4
from specinv_tpu_torch import convert
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.ops import twins
from specinv_tpu_torch.ops.cuda import gl_fullrun

N_FFT, HOP, B, ITERS, LR = 512, 128, 2, 5, 0.5
X_REL = 5e-5
SUM_REL = 1e-5
PLANE_ABS = 1e-4

CASES = [
    (True, "reflect"), (True, "constant"), (True, "replicate"), (True, "circular"),
    (False, "reflect"),
]


def _setup(center, pad_mode, hop=HOP):
    rng = np.random.default_rng(7)
    win = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    kw = dict(window=win, hop_length=hop, center=center, pad_mode=pad_mode)
    jc, w = jcanon(N_FFT // 2 + 1, np.float32, **kw)
    tc, _ = tcanon(N_FFT // 2 + 1, np.float32, **kw)
    clips = rng.standard_normal((B, 7800 if center else 8300)).astype(np.float32)
    spec = np.asarray(jst.stft(jnp.asarray(clips), jc, jnp.asarray(w)))   # (B, T, F)
    T = spec.shape[-2]
    mag = np.abs(spec).astype(np.float32)
    # a Hermitian momentum state: the spectrum with a random phase
    seed = (mag * np.exp(1j * rng.uniform(0, 2 * np.pi, spec.shape))).astype(np.complex64)
    geo = make_geometry4(jc, T, block_t=None)
    pad_rows = ((0, 0), (0, geo.t_pad - T), (0, 0))
    perm = lambda a: fft4.to_permuted(jnp.pad(jnp.asarray(a), pad_rows), N_FFT)  # noqa: E731
    tgt_p = perm(fft4.extend_hermitian_mag(jnp.asarray(mag), N_FFT))
    full = fft4.extend_hermitian_spec(jnp.asarray(seed), N_FFT)
    pre_re, pre_im = perm(full.real), perm(full.imag)
    # the run's own starting point: x0 = istft(seed) in padded coordinates
    from specinv_tpu.ops.framing import pad_center

    x0 = pad_center(jst.istft(jnp.asarray(seed), jc, jnp.asarray(w)), jc)
    x0 = np.asarray(jnp.pad(x0, ((0, 0), (0, geo.lx - geo.lp))), np.float32)
    return jc, tc, w, T, geo, x0, pre_re, pre_im, tgt_p


def _jax_run(jc, w, T, geo, x0, pre_re, pre_im, tgt_p, lane=None, **flags):
    inv_env = j_make_inv_env(jc, jnp.asarray(w), T, geo).astype(jnp.float32)
    return gl_fullrun4.fused_gl_run(
        jnp.asarray(x0), pre_re, pre_im, tgt_p, jnp.asarray(w), inv_env,
        jnp.float32(LR), jc, geo.e, n_iters=ITERS, block_t=geo.block_t,
        interpret=True, precision=jax.lax.Precision.HIGHEST, emit_state=True,
        lane=lane, **flags)


def _port_inputs(tc, w, T, geo, x0, pre_re, pre_im, tgt_p):
    x, pre, tgt = convert.state_from_jax(
        x0, np.asarray(pre_re), np.asarray(pre_im), np.asarray(tgt_p), N_FFT, T)
    tgeo = twins.make_geometry(tc, T)
    assert x.shape[-1] == tgeo.lp
    win = torch.from_numpy(w)
    return (torch.from_numpy(x), torch.from_numpy(pre), torch.from_numpy(tgt), win,
            twins.make_inv_env(tc, win, T, tgeo))


def _close_plane(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=SUM_REL, atol=PLANE_ABS * np.abs(ref).max())


def _check_state_and_magnitude(center, pad_mode, hop=HOP, lane=None):
    jc, tc, w, T, geo, *state = _setup(center, pad_mode, hop)
    jx, jre, jim, jmag = _jax_run(jc, w, T, geo, *state, lane=lane, with_mag=True)
    inputs = _port_inputs(tc, w, T, geo, *state)
    x, pre, mag = gl_fullrun.fused_gl_run(*inputs, LR, tc, ITERS, emit_state=True, with_mag=True)
    ref_x = np.asarray(jx)[:, : x.shape[-1]]
    np.testing.assert_allclose(x.numpy(), ref_x, atol=X_REL * np.abs(ref_x).max(), rtol=0)
    _, ref_pre, _ = convert.state_from_jax(jx, jre, jim, jmag, N_FFT, T)
    _close_plane(pre.numpy().real, ref_pre.real)
    _close_plane(pre.numpy().imag, ref_pre.imag)
    ref_mag = convert.from_permuted(np.asarray(jmag), N_FFT)[:, :T, : N_FFT // 2 + 1]
    _close_plane(mag.numpy(), ref_mag)


@pytest.mark.parametrize("center,pad_mode", CASES)
def test_state_and_magnitude_match_jax(center, pad_mode):
    _check_state_and_magnitude(center, pad_mode)


@pytest.mark.parametrize("center,pad_mode,hop,lane", [
    (True, "reflect", 128, False),
    (False, "reflect", 128, False),
    (True, "circular", 384, None),
    (True, "constant", 384, None),
])
def test_mlane_kernel_dispatch_matches_jax(center, pad_mode, hop, lane):
    """The JAX dispatch to gl_fullrun4._kernel (lane=False, or hop 384 with
    the default valve), held to the port's kernel module at the same bands."""
    jc, _ = jcanon(N_FFT // 2 + 1, np.float32, hop_length=hop, center=center)
    assert not fullrun_lane.supports(jc, lane)  # so fused_gl_run takes _kernel
    _check_state_and_magnitude(center, pad_mode, hop, lane)


@pytest.mark.parametrize("center,pad_mode", CASES)
def test_eval_sums_match_jax(center, pad_mode):
    jc, tc, w, T, geo, *state = _setup(center, pad_mode)
    *_, stats = _jax_run(jc, w, T, geo, *state, with_loss=True,
                         w_loss=gl_fullrun4.hermitian_loss_weight(jc), valid_t=T)
    ref = np.asarray(jnp.sum(stats[:, :2, 0], axis=0))
    inputs = _port_inputs(tc, w, T, geo, *state)
    x, pre, ours = gl_fullrun.fused_gl_run(*inputs, LR, tc, ITERS, emit_state=True, with_loss=True)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=SUM_REL)


def test_outputs_and_valid_t():
    _, tc, w, T, geo, *state = _setup(True, "reflect")
    inputs = _port_inputs(tc, w, T, geo, *state)
    x = gl_fullrun.fused_gl_run(*inputs, LR, tc, 2)
    assert isinstance(x, torch.Tensor) and x.shape == inputs[0].shape
    x2, pre, mag, stats = gl_fullrun.fused_gl_run(
        *inputs, LR, tc, 2, emit_state=True, with_mag=True, with_loss=True, valid_t=T - 4)
    torch.testing.assert_close(x2, x, rtol=0, atol=0)
    m, t = mag[:, : T - 4], inputs[2][:, : T - 4]
    torch.testing.assert_close(stats, torch.stack([((m - t) ** 2).sum(), (m * m).sum()]))
    with pytest.raises(ValueError):
        gl_fullrun.fused_gl_run(*inputs, LR, tc, 1, with_loss=True, valid_t=T + 1)


def test_repad_edges_matches_jax():
    from specinv_tpu.models._pallas_driver import repad_edges as j_repad

    rng = np.random.default_rng(2)
    for center, mode in CASES:
        jc, _ = jcanon(257, np.float32, hop_length=128, center=center, pad_mode=mode)
        tc, _ = tcanon(257, np.float32, hop_length=128, center=center, pad_mode=mode)
        T = 20
        jgeo = make_geometry4(jc, T, block_t=None)
        tgeo = twins.make_geometry(tc, T)
        y = rng.standard_normal((2, tgeo.lp)).astype(np.float32)
        y[:, : tgeo.p_amt] = 0
        y[:, tgeo.e + 1 :] = 0
        ref = np.asarray(j_repad(jnp.asarray(y), jc, jgeo))
        np.testing.assert_array_equal(twins.repad_edges(torch.from_numpy(y), tc, tgeo).numpy(), ref)


def test_supports():
    cfg, _ = tcanon(1025, np.float32, hop_length=512)
    win = torch.hann_window(2048)
    assert gl_fullrun.supports(cfg, win)
    for bins, hop in ((201, 160), (1025, 4096), (4097, 1024)):
        c, _ = tcanon(bins, np.float32, hop_length=hop)
        assert not gl_fullrun.supports(c, torch.ones(c.n_fft))
    assert not gl_fullrun.supports(cfg, win.to(torch.complex64))
