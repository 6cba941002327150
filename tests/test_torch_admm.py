"""The ADMM slice as a whole: specinv_tpu_torch.ADMM on the CPU against
specinv_tpu.ADMM.

* backend='fft' (the literal (X, Y, U, x) chain) against the JAX fft backend
  in float64: 1e-9 relative to the largest sample (the same float64 FFT
  math; differences are summation order, grown over the iterations).  The
  clips are the repo's speech-like corpus: on white noise many bins have
  |Z - U'| near 0, where the projection's phase is set by rounding, and two
  float64 runs drift apart by up to 3.4e-9 in 6 iterations (measured; from
  the same state one step differs by 5e-14 in X on either side), against
  about 1e-10 on speech.
* backend='kernel' (the CUDA kernel's plain version on CPU tensors) against
  the JAX pallas4 whole-run kernel at precision=HIGHEST in float32: 5e-4
  relative, the JAX package's own ADMM band (tests/test_pallas.py), ten
  times its Griffin-Lim band because ADMM's dual integrates rounding.
* backend='kernel' against backend='fft' in float64: 1e-10 relative.  The
  kernel path carries the Douglas-Rachford one-variable form (only Y), the
  fft path the literal chain; they differ by rounding alone.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu_torch.models import common
from specinv_tpu_torch.ops.cuda import _fullrun, admm_fullrun

from .helpers import make_signal, torch_stft

tadmm = importlib.import_module("specinv_tpu_torch.models.admm")

F64_REL = 1e-9
F32_REL = 5e-4
DR_REL = 1e-10


def _mag(x, n_fft, **kw):
    return np.abs(torch_stft(x, n_fft, **kw))


def _speech(shape):
    from specinv_tpu_torch.utils.corpus import make_speech_like

    rows = [make_speech_like(shape[-1], seed=s) for s in range(int(np.prod(shape[:-1])))]
    return np.stack(rows).reshape(shape).astype(np.float64)


def _close(ours, ref, rel):
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, atol=rel * np.abs(ref).max(), rtol=0)


FFT_CASES = {
    "tol0": dict(shape=(22050,), kw=dict(max_iter=8, tol=0.0)),
    "early_stop": dict(shape=(22050,), kw=dict(max_iter=40, tol=1.0, eva_iter=5)),
    "batched": dict(shape=(3, 8000), kw=dict(max_iter=6, tol=0.0)),
    "center_false": dict(shape=(22050,), kw=dict(max_iter=6, tol=0.0, center=False)),
    "complex": dict(shape=(8000,), kw=dict(max_iter=6, tol=0.0), complex=True),
    "rho1": dict(shape=(8000,), kw=dict(max_iter=8, tol=0.0, rho=1.0)),
    "rho1_early_stop": dict(shape=(8000,), kw=dict(max_iter=30, tol=1e-3, eva_iter=4, rho=1.0)),
}


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_backend_matches_jax_f64(case):
    c = FFT_CASES[case]
    x = _speech(c["shape"])
    kw = dict(c["kw"], hop_length=128, verbose=False)
    stft_kw = {"center": kw["center"]} if "center" in kw else {}
    spec = torch_stft(x, 512, hop_length=128, **stft_kw)
    if not c.get("complex"):
        spec = np.abs(spec)
    ref = si.ADMM(spec, backend="fft", **kw)
    ours = st.ADMM(torch.from_numpy(spec), backend="fft", **kw)
    _close(ours, ref, F64_REL)


# the STFT kwarg grid of tests/test_admm.py::test_stft_args, each value at
# least once: (win_length/hann, hop_length, center, normalized, onesided, pad_mode)
STFT_GRID = [
    (None, None, True, False, True, "reflect"),
    (300, 128, True, False, True, "constant"),
    (None, 128, False, True, True, "reflect"),
    (300, None, True, True, False, "reflect"),
    (None, 128, True, False, False, "constant"),
    (300, 128, False, False, False, "reflect"),
]


def _grid_kwargs(win_length, hop_length, center, normalized, onesided, pad_mode):
    window = torch.hann_window(win_length, dtype=torch.float64).numpy() if win_length else None
    return dict(hop_length=hop_length, win_length=win_length, window=window,
                center=center, pad_mode=pad_mode, normalized=normalized,
                onesided=onesided)


@pytest.mark.parametrize("grid", STFT_GRID)
def test_fft_backend_stft_kwargs_match_jax_f64(grid):
    kw = _grid_kwargs(*grid)
    x = _speech((4410,))
    mag = _mag(x, 512, **kw)
    ref = si.ADMM(mag, max_iter=4, tol=0.0, verbose=False, backend="fft", **kw)
    ours = st.ADMM(torch.from_numpy(mag), max_iter=4, tol=0.0, verbose=False,
                   backend="fft", **kw)
    _close(ours, ref, F64_REL)


@pytest.mark.parametrize("kw", [
    dict(max_iter=6, tol=0.0),
    dict(max_iter=6, tol=1e-30, eva_iter=3),
    dict(max_iter=8, tol=1e-30, eva_iter=3, rho=1.0),
], ids=["one_run", "segments", "segments_tail_rho1"])
def test_kernel_backend_matches_jax_pallas4(kw):
    """Both get the same complex64 spectrogram, phase-seeded in float64 (the
    float32 seed's cumulative phase sum differs between XLA and torch by
    summation order; see tests/test_torch_griffin_lim.py)."""
    x = make_signal((2, 8000))
    win = np.hanning(513)[:-1]
    mag = _mag(x, 512, hop_length=128, window=win)
    spec = np.asarray(si.phase_init(mag, hop_length=128, window=win)).astype(np.complex64)
    kw = dict(kw, hop_length=128, window=win.astype(np.float32), verbose=False)
    ref = si.ADMM(spec, backend="pallas4", precision=jax.lax.Precision.HIGHEST, **kw)
    ours = st.ADMM(torch.from_numpy(spec), backend="kernel", **kw)
    _close(ours, ref, F32_REL)


@pytest.mark.parametrize("kw", [
    dict(max_iter=10, tol=0.0),
    dict(max_iter=40, tol=1.0, eva_iter=5),
    dict(max_iter=13, tol=1e-4, eva_iter=5, rho=1.0),
    dict(max_iter=8, tol=0.0, center=False, pad_mode="constant"),
    dict(max_iter=8, tol=0.0, normalized=True, onesided=False),
    dict(max_iter=8, tol=0.0, hop_length=160, pad_mode="circular"),
], ids=["tol0", "early_stop", "tail_rho1", "center_false", "twosided_normalized", "hop160"])
def test_dr_form_equals_literal_chain_f64(kw):
    """The kernel path's one-variable Douglas-Rachford form against the
    literal (X, Y, U, x) chain, both on the port's side in float64."""
    kw = dict({"hop_length": 128}, **kw)
    stft_kw = {k: kw[k] for k in ("hop_length", "center", "pad_mode", "normalized", "onesided")
               if k in kw}
    x = _speech((2, 8000))
    mag = torch.from_numpy(_mag(x, 512, **stft_kw))
    lit = st.ADMM(mag, backend="fft", verbose=False, **kw)
    dr = st.ADMM(mag, backend="kernel", verbose=False, **kw)
    assert dr.dtype == torch.float64
    _close(dr, lit.numpy(), DR_REL)


def test_config2_width_fft_backend():
    """Config-2 width: n_fft 2048, hop 512, hann, 10 s at 22.05 kHz (431
    frames), rho 0.1, 3 iterations, float64."""
    from specinv_tpu_torch.utils.corpus import make_speech_like

    x = make_speech_like(220500, seed=0)
    win = np.hanning(2049)[:-1]
    mag = _mag(x, 2048, hop_length=512, window=win)
    assert mag.shape == (1025, 431)
    kw = dict(max_iter=3, tol=0.0, rho=0.1, hop_length=512, window=win, verbose=False)
    ref = si.ADMM(mag, backend="fft", **kw)
    ours = st.ADMM(torch.from_numpy(mag), backend="fft", **kw)
    _close(ours, ref, F64_REL)


@pytest.mark.parametrize("grid", [
    (None, None, True, False, True, "reflect"),
    (None, 128, True, False, False, "constant"),
    (100, 32, False, True, True, "reflect"),
], ids=["defaults", "twosided", "normalized_hann100"])
def test_gradient_matches_jax(grid):
    """d mean((y - x)^2) / d mag through 2 iterations of the literal path
    (the SPSI seed included), float64, as tests/test_admm.py differentiates
    the JAX ADMM over its kwarg grid."""
    kw = _grid_kwargs(*grid)
    x = make_signal((2000,))
    mag = _mag(x, 128, **kw)

    def jloss(s):
        y = si.ADMM(s, max_iter=2, tol=0.0, verbose=False, backend="fft", **kw)
        n = min(y.shape[0], x.shape[0])
        return jnp.mean((y[:n] - jnp.asarray(x[:n])) ** 2)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(mag)))
    m = torch.from_numpy(mag).requires_grad_(True)
    y = st.ADMM(m, max_iter=2, tol=0.0, verbose=False, backend="fft", **kw)
    n = min(y.shape[0], x.shape[0])
    torch.mean((y[:n] - torch.from_numpy(x[:n])) ** 2).backward()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(m.grad.numpy(), ref, atol=1e-9 * np.abs(ref).max(), rtol=0)


def test_kernel_autograd_function_replays_twin(monkeypatch):
    """The autograd.Function around the kernel: forward from the launch,
    backward from the plain twin.  With the launch swapped for its plain
    version on the CPU, its gradients equal plain autograd's."""
    def cpu_launch(kernel, counter, x_pad, Y, target, window, inv_env, rho, cfg, n_iters,
                   with_mag, with_loss, valid):
        x, y, mag = admm_fullrun.fused_admm_run_reference(
            x_pad, Y, target, window, inv_env, rho, cfg, n_iters, emit_state=True,
            with_mag=True, valid_t=valid)
        return x, y, (mag if with_mag else None), None

    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.ops import twins

    cfg, w = canonicalize(65, np.float64, hop_length=32)
    T = 12
    geo = twins.make_geometry(cfg, T)
    rng = np.random.default_rng(0)
    win = torch.from_numpy(np.hanning(129)[:-1])
    inv_env = twins.make_inv_env(cfg, win, T, geo)
    tgt = torch.from_numpy(np.abs(rng.standard_normal((1, T, 65)))).requires_grad_(True)
    y0 = torch.from_numpy(rng.standard_normal((1, T, 65)) + 1j * rng.standard_normal((1, T, 65)))
    y0.requires_grad_(True)
    x0 = torch.from_numpy(rng.standard_normal((1, geo.lp))).requires_grad_(True)

    def loss(out):
        x, y = out
        return (x ** 2).sum() + (y.abs() ** 2).sum()

    for valid_t in (0, T - 3):
        g_plain = torch.autograd.grad(loss(admm_fullrun.fused_admm_run_reference(
            x0, y0, tgt, win, inv_env, 0.3, cfg, 3, emit_state=True, valid_t=valid_t)),
            (x0, y0, tgt))
        monkeypatch.setattr(_fullrun, "launch", cpu_launch)
        # the Function takes the frame count itself (0 above is all T)
        x, y, _mag = _fullrun.Run.apply(
            admm_fullrun.KERNEL, x0, y0, tgt, win, inv_env, 0.3, cfg, 3, True, False,
            valid_t or T, "launches")
        g_fn = torch.autograd.grad(loss((x, y)), (x0, y0, tgt))
        for a, b in zip(g_fn, g_plain):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=0)


def test_backend_dispatch(monkeypatch):
    from specinv_tpu_torch.config import canonicalize

    mag = torch.from_numpy(_mag(make_signal((4000,)), 256))
    taken = []
    for name in ("run_tm", "run_tm_kernel"):
        fn = getattr(tadmm, name)
        monkeypatch.setattr(tadmm, name, lambda *a, _fn=fn, _n=name, **k: (
            taken.append(_n), _fn(*a, **k))[1])
    st.ADMM(mag, max_iter=2, verbose=False)
    st.ADMM(mag, max_iter=2, verbose=False, backend="kernel")
    assert taken == ["run_tm", "run_tm_kernel"]  # CPU 'auto' is the literal path
    cfg, w = canonicalize(1025, np.float32, hop_length=512)
    cuda = torch.device("cuda")
    assert common.resolve_backend("auto", cfg, torch.from_numpy(w), cuda) == "kernel"
    odd = torch.rand(201, 20)  # n_fft 400: no power of two
    with pytest.raises(ValueError, match="power of two"):
        st.ADMM(odd, max_iter=2, verbose=False, backend="kernel")
    assert st.ADMM(odd, max_iter=2, verbose=False).shape[-1] > 0
    with pytest.raises(ValueError, match="pack applies to the whole-run pallas4 kernel only"):
        st.ADMM(mag, max_iter=2, verbose=False, pack=2)  # CPU 'auto' resolves to 'fft'
    for bad in (dict(loss_psum_axes=("data",)), dict(precision="bf16x2"),
                dict(backend="pallas"), dict(backend="pallas4"), dict(tol=-1.0),
                dict(eva_iter=0)):
        with pytest.raises(ValueError):
            st.ADMM(mag, max_iter=2, verbose=False, **bad)
    with pytest.raises(TypeError):
        st.ADMM(mag, max_iter=2, verbose=False, hop_lenght=64)
    assert st.admm is st.ADMM


def test_output_layout_and_dtypes():
    mag = torch.from_numpy(_mag(make_signal((4000,)), 256))
    y = st.ADMM(mag, max_iter=2, verbose=False)
    assert y.ndim == 1 and y.dtype == torch.float64
    y3 = st.ADMM(mag[None], max_iter=2, verbose=False)
    assert y3.shape == (1, y.shape[0])
    yb = st.ADMM(mag.to(torch.bfloat16), max_iter=2, verbose=False)
    assert yb.dtype == torch.float32 and torch.isfinite(yb).all()
    yk = st.ADMM(mag.float(), max_iter=2, verbose=False, backend="kernel")
    assert yk.dtype == torch.float32 and yk.shape == y.shape
    spec = torch.from_numpy(torch_stft(make_signal((4000,)), 256))
    assert st.ADMM(spec, max_iter=2, verbose=False).shape == y.shape
    ref = np.asarray(si.ADMM(mag.numpy(), max_iter=2, verbose=False))
    assert ref.shape == tuple(y.shape)


def test_modes_agree_and_early_stop_freezes():
    x = make_signal((8000,))
    mag = torch.from_numpy(_mag(x, 256))
    kw = dict(max_iter=60, tol=1.0, eva_iter=5, verbose=False)
    for backend in ("fft", "kernel"):
        a = st.ADMM(mag, mode="fori", backend=backend, **kw)
        b = st.ADMM(mag, mode="while", backend=backend, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        # the stop fires at the second eval: 10 iterations, not 60
        c = st.ADMM(mag, max_iter=10, tol=0.0, backend=backend, verbose=False)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-12 * float(c.abs().max()))


@pytest.mark.parametrize("backend", ["matmul", "matmul4"])
def test_xla_dft_backends_name_the_ports_counterpart(backend):
    """As for griffin_lim: JAX's ADMM runs the XLA lowering, the port raises
    naming 'fft' and 'dft' (``common.resolve_backend``, shared)."""
    mag = _mag(make_signal((4000,)), 256).astype(np.float32)  # matmul4: float32
    assert np.isfinite(np.asarray(si.ADMM(mag, max_iter=2, verbose=False,
                                          backend=backend))).all()
    with pytest.raises(ValueError, match="the port's counterpart is 'fft'.*'dft'"):
        st.ADMM(torch.from_numpy(mag), max_iter=2, verbose=False, backend=backend)
