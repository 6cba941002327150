"""Plain version of the device FFT (csrc/fft.cu, csrc/rfft.cuh) against the JAX package's
four-step transform fft4.fwd4 / inv4_real at precision=HIGHEST.

float32 on both sides: atol 1e-5 relative to the largest output (f32
rounding over log2(n) stages on one side and two 128-deep f32 dots on the
other).  The CUDA kernel itself is held against fft_reference on the card by
chip_smoke.py; here the wrapper must take the plain version for CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specinv_tpu.ops.pallas import fft4
from specinv_tpu_torch.ops.cuda import fft

HI = jax.lax.Precision.HIGHEST
REL = 1e-5


def _frames(n, rows=24, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(np.float32)


@pytest.mark.parametrize("n_fft", [256, 512])
@pytest.mark.parametrize("normalized", [False, True])
def test_forward_matches_fwd4(n_fft, normalized):
    x = _frames(n_fft)
    t = fft4.tables_as_jnp(n_fft, normalized)
    s_re, s_im = fft4.fwd4(jnp.asarray(x), t, HI)
    ref = np.asarray(fft4.from_permuted(s_re, n_fft)) + 1j * np.asarray(
        fft4.from_permuted(s_im, n_fft))
    full = fft.fft_reference(torch.from_numpy(x), normalized, onesided=False).numpy()
    np.testing.assert_allclose(full, ref, atol=REL * np.abs(ref).max(), rtol=0)
    half = fft.fft_reference(torch.from_numpy(x), normalized, onesided=True).numpy()
    np.testing.assert_allclose(half, ref[:, : n_fft // 2 + 1], atol=REL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("n_fft", [256, 512])
@pytest.mark.parametrize("normalized", [False, True])
def test_inverse_matches_inv4_real(n_fft, normalized):
    rng = np.random.default_rng(1)
    n_bins = n_fft // 2 + 1
    half = (rng.standard_normal((24, n_bins)) + 1j * rng.standard_normal((24, n_bins))).astype(np.complex64)
    full = np.asarray(fft4.extend_hermitian_spec(jnp.asarray(half), n_fft))
    t = fft4.tables_as_jnp(n_fft, normalized)
    ref = np.asarray(fft4.inv4_real(
        fft4.to_permuted(jnp.asarray(full.real), n_fft),
        fft4.to_permuted(jnp.asarray(full.imag), n_fft), t, HI))
    ours = fft.ifft_reference(torch.from_numpy(half), n_fft, normalized, onesided=True).numpy()
    np.testing.assert_allclose(ours, ref, atol=REL * np.abs(ref).max(), rtol=0)
    ours2 = fft.ifft_reference(torch.from_numpy(full), n_fft, normalized, onesided=False).numpy()
    np.testing.assert_allclose(ours2, ref, atol=REL * np.abs(ref).max(), rtol=0)


def test_wrappers_take_plain_version_on_cpu():
    x = torch.from_numpy(_frames(512))
    before = fft.launches
    spec = fft.fft(x, onesided=True)
    torch.testing.assert_close(spec, fft.fft_reference(x))
    torch.testing.assert_close(fft.ifft(spec, 512), fft.ifft_reference(spec, 512))
    assert fft.launches == before  # no kernel launched for CPU tensors


def test_twiddles_and_sizes():
    tw = fft.twiddles(64, torch.device("cpu"))
    ref = np.exp(-2j * np.pi * np.arange(32) / 64)
    np.testing.assert_allclose(tw.numpy(), ref, atol=1e-7)
    assert fft.supported_size(16) and fft.supported_size(4096)
    assert not fft.supported_size(8) and not fft.supported_size(8192)
    assert not fft.supported_size(400)


# Every size the device transform takes, each way of storing and scaling the
# spectrum: on a CPU tensor the wrappers run the plain version, which must be
# numpy's transform (the card's kernels are held to it at these sizes).
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("n", [1 << k for k in range(4, 13)])
def test_cpu_wrappers_are_numpy_transforms_at_every_size(n, onesided):
    x = np.random.default_rng(n).standard_normal((5, n))
    for normalized in (False, True):
        spec = fft.fft(torch.from_numpy(x.astype(np.float32)), normalized, onesided)
        ref = (np.fft.rfft if onesided else np.fft.fft)(x, norm="ortho" if normalized else None)
        assert spec.shape == ref.shape
        np.testing.assert_allclose(spec.numpy(), ref, rtol=0, atol=REL * np.abs(ref).max())
        back = fft.ifft(spec, n, normalized, onesided)
        np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=REL * np.abs(x).max())


# The twiddle table every kernel of the transform reads: complex128, rounded
# once from float64.
@pytest.mark.parametrize("n", [1 << k for k in range(4, 13)])
def test_twiddle_table_at_every_size(n):
    tw = fft.twiddles(n, torch.device("cpu"), torch.complex128)
    assert tw.dtype == torch.complex128 and tw.shape == (n // 2,)
    np.testing.assert_array_equal(tw.numpy(), np.exp(-2j * np.pi * np.arange(n // 2) / n))
    assert fft.supported_size(n)
    assert not fft.supported_size(n + 2) and not fft.supported_size(3 * n // 2)
