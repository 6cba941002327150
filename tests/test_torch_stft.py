"""STFT layer of specinv_tpu_torch against specinv_tpu in float64.

Tolerance: atol 1e-10 relative to the max of the JAX output (both sides use
pocketfft-class float64 FFTs; the differences are summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specinv_tpu import transforms as jtr
from specinv_tpu.config import canonicalize as jcanon
from specinv_tpu.ops import framing as jfr
from specinv_tpu.ops import stft as jst
from specinv_tpu_torch import transforms as ttr
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.ops import framing as tfr
from specinv_tpu_torch.ops import stft as tst

from .helpers import make_signal

REL = 1e-10


def _close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=REL * max(np.abs(ref).max(), 1e-300), rtol=0)


def _configs(bins, **kw):
    jc, w = jcanon(bins, np.float64, **kw)
    tc, _ = tcanon(bins, np.float64, **kw)
    return jc, tc, w


@pytest.mark.parametrize("nfft", [128, 256, 512])
@pytest.mark.parametrize("center,pad_mode", [
    (True, "reflect"), (True, "constant"), (True, "replicate"), (True, "circular"),
    (False, "reflect"),
])
def test_stft_istft_envelope(nfft, center, pad_mode):
    x = make_signal((2, 4410))
    win = np.hanning(nfft + 1)[:-1]
    jc, tc, w = _configs(nfft // 2 + 1, window=win, center=center, pad_mode=pad_mode)
    js = jst.stft(jnp.asarray(x), jc, jnp.asarray(w))
    ts = tst.stft(torch.from_numpy(x), tc, torch.from_numpy(w))
    _close(ts, js)
    T = js.shape[-2]
    _close(tst.make_envelope(tc, torch.from_numpy(w), T), jst.make_envelope(jc, jnp.asarray(w), T))
    _close(tst.istft(ts, tc, torch.from_numpy(w)), jst.istft(js, jc, jnp.asarray(w)))


@pytest.mark.parametrize("hop", [None, 100])
@pytest.mark.parametrize("win_length", [None, 300])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("onesided", [True, False])
def test_public_transforms_kwarg_grid(hop, win_length, normalized, onesided):
    x = make_signal((2, 4410))
    kw = dict(hop_length=hop, win_length=win_length, normalized=normalized, onesided=onesided)
    js = jtr.stft(jnp.asarray(x), 512, **kw)
    ts = ttr.stft(torch.from_numpy(x), 512, **kw)
    _close(ts, js)
    _close(ttr.istft(ts, **kw), jtr.istft(js, **kw))
    _close(ttr.istft(ts, length=4410, **kw), jtr.istft(js, length=4410, **kw))


def test_stft_matches_torch_stft():
    x = make_signal((4410,))
    win = torch.hann_window(512, dtype=torch.float64)
    ref = torch.stft(torch.from_numpy(x), 512, window=win, return_complex=True)
    ours = ttr.stft(torch.from_numpy(x), 512, window=win)
    torch.testing.assert_close(ours, ref, atol=1e-8, rtol=0)


def test_framing_primitives():
    x = make_signal((3, 1000))
    jc, tc, _ = _configs(257, hop_length=96, pad_mode="replicate")
    _close(tfr.pad_center(torch.from_numpy(x), tc), jfr.pad_center(jnp.asarray(x), jc))
    fr = jfr.frame(jnp.asarray(x), 300, 96)
    _close(tfr.frame(torch.from_numpy(x), 300, 96), fr)
    _close(tfr.overlap_add(torch.from_numpy(np.asarray(fr)), 96), jfr.overlap_add(fr, 96))
    w2 = np.hanning(300) ** 2
    _close(tfr.ola_envelope(torch.from_numpy(w2), 9, 96), jfr.ola_envelope(jnp.asarray(w2), 9, 96))


def test_zero_envelope_warns_and_is_guarded():
    """hann + center=False leaves a zero envelope at sample 0: the port warns
    with the JAX package's message and divides by 1 there, as JAX does."""
    x = make_signal((4410,))
    win = np.hanning(257)[:-1]
    jc, tc, w = _configs(129, window=win, center=False)
    js = jst.stft(jnp.asarray(x), jc, jnp.asarray(w))
    with pytest.warns(RuntimeWarning, match="OLA envelope contains zeros"):
        ours = tst.istft(torch.from_numpy(np.asarray(js)), tc, torch.from_numpy(w))
    _close(ours, jst.istft(js, jc, jnp.asarray(w)))


def test_istft_rejects_real_input():
    with pytest.raises(TypeError):
        ttr.istft(torch.zeros(257, 10))
