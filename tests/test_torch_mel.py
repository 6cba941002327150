"""The port's mel frontend against ``specinv_tpu.ops.mel``, in float64.

* ``mel_filterbank``, ``hz_to_mel`` / ``mel_to_hz``: equal to the JAX
  package's (the same numpy arithmetic) over the configurations of
  ``tests/test_mel.py`` (htk and Slaney scales, fmin / fmax, ``norm=None``).
* ``mel_to_linear`` (one clip and a batch) and ``log_mel_transform`` (one
  and a batch of clips) within 1e-10 relative of the JAX package's; the
  gradient of a loss through ``log_mel_transform`` against ``jax.grad``
  within 1e-9.
* ``mel_to_audio`` at ``tol=0`` against the JAX package's on the same
  backend class (the port's ``'fft'``, which ``'auto'`` is on the CPU,
  against JAX's CPU ``'auto'``), within 1e-9 of the max (the port's
  cross-package band for Griffin-Lim), and its forwarding of
  ``griffin_lim``'s kwargs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu.ops import mel as jmel
from specinv_tpu_torch.ops import mel as tmel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and more threads only
    contend with the suite's other workers (3x slower under a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FILTERBANKS = [
    # (n_fft, n_mels, sr, fmin, fmax, htk, norm): tests/test_mel.py's
    (512, 64, 22050.0, 0.0, None, False, "slaney"),
    (512, 32, 16000.0, 0.0, None, False, "slaney"),
    (512, 32, 16000.0, 0.0, None, True, "slaney"),
    (2048, 128, 22050.0, 0.0, None, False, "slaney"),
    (2048, 80, 22050.0, 0.0, 8000.0, True, None),
    (1024, 64, 16000.0, 50.0, 7600.0, False, None),
    (1024, 64, 16000.0, 50.0, 7600.0, True, "slaney"),
]


@pytest.mark.parametrize("cfg", FILTERBANKS)
def test_filterbank_equals_jax(cfg):
    n_fft, n_mels, sr, fmin, fmax, htk, norm = cfg
    for dtype in ("float32", "float64"):
        kw = dict(fmin=fmin, fmax=fmax, htk=htk, norm=norm, dtype=dtype)
        ours = tmel.mel_filterbank(n_fft, n_mels, sr, **kw)
        assert ours.dtype == np.dtype(dtype) and ours.shape == (n_fft // 2 + 1, n_mels)
        np.testing.assert_array_equal(ours, jmel.mel_filterbank(n_fft, n_mels, sr, **kw))


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_equals_jax(htk):
    f = np.linspace(0.0, 11025.0, 97)
    np.testing.assert_array_equal(tmel.hz_to_mel(f, htk), jmel.hz_to_mel(f, htk))
    m = tmel.hz_to_mel(f, htk)
    np.testing.assert_array_equal(tmel.mel_to_hz(m, htk), jmel.mel_to_hz(m, htk))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("shape,n_fft,sr", [((64, 24), 512, 22050.0),
                                            ((3, 32, 10), 256, 16000.0)])
def test_mel_to_linear_matches_jax(shape, n_fft, sr):
    mel = np.random.default_rng(1).random(shape)
    ours = st.mel_to_linear(torch.from_numpy(mel), n_fft, sr)
    ref = si.mel_to_linear(jnp.asarray(mel), n_fft, sr)
    assert ours.shape == ref.shape and ours.dtype == torch.float64
    assert _rel(ours.numpy(), ref) < 1e-10


def test_mel_to_linear_keeps_the_working_type():
    mel = np.random.default_rng(2).random((32, 10)).astype(np.float32)
    ours = st.mel_to_linear(torch.from_numpy(mel), 256, 16000.0, power=1.0, max_iter=20)
    ref = si.mel_to_linear(jnp.asarray(mel), 256, 16000.0, power=1.0, max_iter=20)
    assert ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) < 1e-5


SR, N_FFT, N_MELS = 22050, 512, 64


@pytest.mark.parametrize("batch", [None, 2])
def test_log_mel_transform_matches_jax(batch):
    x = np.random.default_rng(0).standard_normal((4096,) if batch is None else (batch, 4096))
    for dtype in (np.float32, np.float64):  # the window and filterbank's type
        kw = dict(n_fft=N_FFT, n_mels=N_MELS, sample_rate=SR, hop_length=128, dtype=dtype)
        ours = st.log_mel_transform(**kw)(torch.from_numpy(x))
        ref = si.log_mel_transform(**kw)(jnp.asarray(x))
        assert ours.shape == ref.shape == x.shape[:-1] + (N_MELS, 33)
        assert ours.dtype == torch.float64
        assert _rel(ours.numpy(), ref) < 1e-10


def test_log_mel_gradient_matches_jax():
    rng = np.random.default_rng(4)
    x, w = rng.standard_normal(4096), rng.standard_normal((N_MELS, 33))
    window = np.hanning(N_FFT + 1)[:-1]
    kw = dict(n_fft=N_FFT, n_mels=N_MELS, sample_rate=SR, window=window, dtype=np.float64)
    fj, ft = si.log_mel_transform(**kw), st.log_mel_transform(**kw)
    ref = jax.grad(lambda v: jnp.sum(fj(v) * jnp.asarray(w)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ft(xt) * torch.from_numpy(w)).sum().backward()
    assert _rel(xt.grad.numpy(), ref) < 1e-9


@pytest.mark.parametrize("log_input", [False, True])
def test_mel_to_audio_matches_jax(log_input):
    x = np.random.default_rng(5).standard_normal(8192)
    kw = dict(n_fft=N_FFT, n_mels=N_MELS, sample_rate=SR, dtype=np.float64)
    logmel = np.array(si.log_mel_transform(**kw)(jnp.asarray(x)))
    mel = logmel if log_input else np.exp(logmel) - 1e-6
    call = dict(log_input=log_input, max_iter=30, tol=0.0, nnls_iter=50)
    ours = st.mel_to_audio(torch.from_numpy(mel), N_FFT, SR, **call)
    ref = np.asarray(si.mel_to_audio(jnp.asarray(mel), N_FFT, SR, **call))
    assert ours.shape == ref.shape and ours.ndim == 1
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-9 * np.abs(ref).max())


def test_mel_to_audio_passes_gl_kwargs():
    """window, hop_length, backend and precision flow through to
    griffin_lim; so do its errors."""
    mel = np.random.default_rng(2).random((32, 12))
    win = np.hanning(257)[:-1]
    kw = dict(window=win, hop_length=64, max_iter=4, tol=0.0)
    ours = st.mel_to_audio(torch.from_numpy(mel), 256, SR, backend="fft", **kw)
    ref = np.asarray(si.mel_to_audio(jnp.asarray(mel), 256, SR, backend="fft", **kw))
    assert ours.ndim == 1 and bool(torch.isfinite(ours).all())
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-9 * np.abs(ref).max())
    # 'dft' on a CPU tensor runs the kernel's plain version at that precision
    lin = st.mel_to_linear(torch.from_numpy(mel), 256, SR)
    dft = st.mel_to_audio(torch.from_numpy(mel), 256, SR, backend="dft", precision="highest",
                          **kw)
    torch.testing.assert_close(dft, st.griffin_lim(lin, backend="dft", precision="highest",
                                                   verbose=False, **kw), rtol=0, atol=0)
    with pytest.raises(TypeError, match="bogus"):
        st.mel_to_audio(torch.from_numpy(mel), 256, SR, bogus=1, **kw)
    with pytest.raises(ValueError, match="precision"):
        st.mel_to_audio(torch.from_numpy(mel), 256, SR, backend="fft", precision="bf16x2", **kw)
