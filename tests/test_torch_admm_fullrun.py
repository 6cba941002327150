"""The module that holds the whole-run ADMM kernel, on the CPU.

The port's fused_admm_run takes its plain version for CPU tensors; it is held
against the JAX driver admm_fused4.fused_admm_run run in Pallas interpret
mode at precision=HIGHEST, on the same state carried across by
convert.state_from_jax.  n_fft 512, hop 128, B=2, 61 frames, 5 iterations,
rho 0.1 and 1.0, every pad mode and center=False, through both JAX
dispatches: lane=None reaches fullrun_lane._kernel (algo='admm'), lane=False
admm_fused4._kernel_full; hop 384 reaches _kernel_full by default.

Tolerances (float32 on both sides) come from a float64 run of the port's
plain version on the same inputs.  After 5 iterations, over the cases
below, the float32 sides lie at most this far from it, relative to the max
(port / JAX): x 4.1e-5 / 8.0e-5; the Y planes 6.5e-4 / 2.6e-3; |R|
1.3e-4 / 2.7e-4; the eval sums 2.6e-7 / 1.3e-7 (relative).  Each band is
about twice the sum of the two.  The Y planes drift most, where |Z - U'| is
at rounding level and the projection's phase is set by rounding: ADMM's
dual integrates it, about 10x Griffin-Lim's drift.  A wrong sign in the
update (Y' = P - U') moves x by 0.94 of its max.
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
from specinv_tpu.ops.framing import pad_center
from specinv_tpu.ops.pallas import admm_fused4, fft4, gl_fullrun4
from specinv_tpu_torch import convert
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.ops import twins
from specinv_tpu_torch.ops.cuda import admm_fullrun

N_FFT, B, ITERS = 512, 2, 5
X_REL = 2.5e-4
Y_ABS = 7e-3
MAG_ABS = 8e-4
SUM_REL = 1e-6

# (center, pad_mode, rho, lane, hop)
CASES = [
    (True, "reflect", 0.1, None, 128),
    (True, "constant", 0.1, None, 128),
    (True, "replicate", 1.0, None, 128),
    (True, "circular", 1.0, None, 128),
    (False, "reflect", 0.1, None, 128),
    (True, "reflect", 1.0, False, 128),
    (True, "constant", 0.1, False, 128),
    (True, "circular", 0.1, False, 128),
    (False, "reflect", 1.0, False, 128),
    (True, "reflect", 0.1, None, 384),
]


def _setup(center, pad_mode, hop):
    rng = np.random.default_rng(11)
    win = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    kw = dict(window=win, hop_length=hop, center=center, pad_mode=pad_mode)
    jc, w = jcanon(N_FFT // 2 + 1, np.float32, **kw)
    tc, _ = tcanon(N_FFT // 2 + 1, np.float32, **kw)
    clips = rng.standard_normal((B, 7800 if center else 8300)).astype(np.float32)
    spec = np.asarray(jst.stft(jnp.asarray(clips), jc, jnp.asarray(w)))   # (B, T, F)
    T = spec.shape[-2]
    mag = np.abs(spec).astype(np.float32)
    # a Hermitian Y0 (= X0, U0 = 0): the spectrum with a random phase
    seed = (mag * np.exp(1j * rng.uniform(0, 2 * np.pi, spec.shape))).astype(np.complex64)
    geo = make_geometry4(jc, T, block_t=None)
    pad_rows = ((0, 0), (0, geo.t_pad - T), (0, 0))
    perm = lambda a: fft4.to_permuted(jnp.pad(jnp.asarray(a), pad_rows), N_FFT)  # noqa: E731
    tgt_p = perm(fft4.extend_hermitian_mag(jnp.asarray(mag), N_FFT))
    full = fft4.extend_hermitian_spec(jnp.asarray(seed), N_FFT)
    y_re, y_im = perm(full.real), perm(full.imag)
    # the run's own starting point: x0 = istft(Y0) in padded coordinates
    x0 = pad_center(jst.istft(jnp.asarray(seed), jc, jnp.asarray(w)), jc)
    x0 = np.asarray(jnp.pad(x0, ((0, 0), (0, geo.lx - geo.lp))), np.float32)
    return jc, tc, w, T, geo, x0, y_re, y_im, tgt_p


def _jax_run(jc, w, T, geo, x0, y_re, y_im, tgt_p, rho, lane, **flags):
    inv_env = j_make_inv_env(jc, jnp.asarray(w), T, geo).astype(jnp.float32)
    return admm_fused4.fused_admm_run(
        jnp.asarray(x0), y_re, y_im, tgt_p, jnp.asarray(w), inv_env,
        jnp.float32(rho), jc, valid_t=T, e=geo.e, n_iters=ITERS,
        block_t=geo.block_t, interpret=True, precision=jax.lax.Precision.HIGHEST,
        emit_state=True, lane=lane, **flags)


def _port_inputs(tc, w, T, x0, y_re, y_im, tgt_p, dtype=torch.float32):
    x, y, tgt = convert.state_from_jax(
        x0, np.asarray(y_re), np.asarray(y_im), np.asarray(tgt_p), N_FFT, T)
    tgeo = twins.make_geometry(tc, T)
    assert x.shape[-1] == tgeo.lp
    win = torch.from_numpy(w).to(dtype)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    return (torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=cdt),
            torch.tensor(tgt, dtype=dtype), win, twins.make_inv_env(tc, win, T, tgeo))


def _close_plane(ours, ref, band):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=band * np.abs(ref).max())


@pytest.mark.parametrize("center,pad_mode,rho,lane,hop", CASES)
def test_matches_jax(center, pad_mode, rho, lane, hop):
    jc, tc, w, T, geo, *state = _setup(center, pad_mode, hop)
    lane_engine = gl_fullrun4.lane_active(jc, geo.block_t, lane)
    assert lane_engine == (lane is None and hop == 128)
    flags = dict(with_mag=True)
    if lane_engine:  # the eval sums exist on the lane engine only
        flags.update(with_loss=True, w_loss=gl_fullrun4.hermitian_loss_weight(jc))
    jx, jre, jim, jmag, *jstats = _jax_run(jc, w, T, geo, *state, rho, lane, **flags)
    inputs = _port_inputs(tc, w, T, *state)
    x, y, mag, stats = admm_fullrun.fused_admm_run(
        *inputs, rho, tc, ITERS, emit_state=True, with_mag=True, with_loss=True)
    ref_x = np.asarray(jx)[:, : x.shape[-1]]
    np.testing.assert_allclose(x.numpy(), ref_x, atol=X_REL * np.abs(ref_x).max(), rtol=0)
    _, ref_y, _ = convert.state_from_jax(jx, jre, jim, jmag, N_FFT, T)
    _close_plane(y.numpy().real, ref_y.real, Y_ABS)
    _close_plane(y.numpy().imag, ref_y.imag, Y_ABS)
    ref_mag = convert.from_permuted(np.asarray(jmag), N_FFT)[:, :T, : N_FFT // 2 + 1]
    _close_plane(mag.numpy(), ref_mag, MAG_ABS)
    if jstats:
        ref = np.asarray(jnp.sum(jstats[0][:, :2, 0], axis=0))
        np.testing.assert_allclose(stats.numpy(), ref, rtol=SUM_REL)


def test_valid_t_mask_and_outputs():
    """valid_t < T zeroes Y on the frames past it, which the frames' share
    of x then lacks, and limits the eval sums."""
    _, tc, w, T, geo, *state = _setup(True, "reflect", 128)
    inputs = _port_inputs(tc, w, T, *state)
    x = admm_fullrun.fused_admm_run(*inputs, 0.1, tc, 2)
    assert isinstance(x, torch.Tensor) and x.shape == inputs[0].shape
    x_all, y_all = admm_fullrun.fused_admm_run(*inputs, 0.1, tc, 2, emit_state=True, valid_t=T)
    torch.testing.assert_close(x_all, x, rtol=0, atol=0)
    v = T - 4
    x2, y2, mag, stats = admm_fullrun.fused_admm_run(
        *inputs, 0.1, tc, 2, emit_state=True, with_mag=True, with_loss=True, valid_t=v)
    assert bool((y2[:, v:] == 0).all()) and bool((y2[:, :v] != 0).any())
    # the same two masked iterations of the plain twin by hand
    geo_t = twins.make_geometry(tc, T)
    state_1, _ = twins.admm_twin(inputs[:2], *inputs[2:5], 0.1, tc, geo_t, v)
    (xr, yr), _ = twins.admm_twin(state_1, *inputs[2:5], 0.1, tc, geo_t, v)
    torch.testing.assert_close(x2, xr, rtol=0, atol=0)
    torch.testing.assert_close(y2, yr, rtol=0, atol=0)
    assert not torch.equal(x2, x_all)
    m, t = mag[:, :v], inputs[2][:, :v]
    torch.testing.assert_close(stats, torch.stack([((m - t) ** 2).sum(), (m * m).sum()]))
    with pytest.raises(ValueError):
        admm_fullrun.fused_admm_run(*inputs, 0.1, tc, 1, with_loss=True, valid_t=T + 1)


def test_kernel_wrapper_contract():
    """The wrapper shares the Griffin-Lim kernel's config check and refuses
    a CUDA launch it cannot make before touching the card."""
    cfg, _ = tcanon(1025, np.float32, hop_length=512)
    assert admm_fullrun.supports(cfg, torch.hann_window(2048))
    odd, _ = tcanon(201, np.float32, hop_length=100)
    assert not admm_fullrun.supports(odd, torch.ones(400))
    meta = torch.empty(1, 10, device="meta")
    with pytest.raises(ValueError, match="power of two"):
        admm_fullrun.fused_admm_run(meta, meta, meta, torch.ones(400, device="meta"),
                                    meta, 0.1, odd, 1)
