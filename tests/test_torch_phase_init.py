"""SPSI phase seed of specinv_tpu_torch against specinv_tpu in float64.

The seed is elementwise math (held at atol 1e-12 on few frames) plus one
cumulative sum of phase increments over time.  XLA and torch take that sum
in different orders, so over T frames the phase (hundreds of radians) may
differ by about T ulps: the long-clip test allows 1e-12 * T relative to the
largest magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu.config import canonicalize as jcanon
from specinv_tpu.models.phase_init import phase_init_tm as j_phase_init_tm
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.models.phase_init import phase_init_tm

from .helpers import make_signal, torch_stft


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (512, 128), (512, 100)])
def test_phase_init_tm_matches_jax(n_fft, hop):
    x = make_signal((2, 8000))
    mag = np.abs(torch_stft(x, n_fft, hop_length=hop))          # (B, F, T)
    tm = np.swapaxes(mag, -1, -2)
    jc, _ = jcanon(mag.shape[-2], np.float64, hop_length=hop)
    tc, _ = tcanon(mag.shape[-2], np.float64, hop_length=hop)
    ref = np.asarray(j_phase_init_tm(jnp.asarray(tm), jc))
    ours = phase_init_tm(torch.from_numpy(tm), tc).numpy()
    T = tm.shape[-2]
    np.testing.assert_allclose(ours, ref, atol=1e-12 * T * np.abs(ref).max(), rtol=0)


def test_overwrite_priority_adjacent_peaks():
    """Peaks two bins apart share a neighbour: the write order decides it."""
    row = np.array([0.0, 1.0, 0.2, 1.5, 0.1, 0.3, 0.05, 0.9, 0.0])
    tm = np.stack([row, row[::-1], row * 2])[None]
    jc, _ = jcanon(tm.shape[-1], np.float64)
    tc, _ = tcanon(tm.shape[-1], np.float64)
    ref = np.asarray(j_phase_init_tm(jnp.asarray(tm), jc))
    ours = phase_init_tm(torch.from_numpy(tm), tc).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-12, rtol=0)


def test_public_phase_init_layout():
    x = make_signal((4410,))
    mag = np.abs(torch_stft(x, 256))
    ref = np.asarray(si.phase_init(mag))
    ours = st.phase_init(torch.from_numpy(mag)).numpy()
    assert ours.shape == mag.shape
    np.testing.assert_allclose(ours, ref, atol=1e-12 * mag.shape[-1] * np.abs(ref).max(), rtol=0)
    with pytest.raises(ValueError):
        st.phase_init(torch.from_numpy(mag).to(torch.complex128))
