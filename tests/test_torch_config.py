"""specinv_tpu_torch.config against specinv_tpu.config: same fields, same
window, over the kwarg grid of tests/test_stft.py."""
import numpy as np
import pytest
import torch

from specinv_tpu import config as jcfg
from specinv_tpu_torch import config as tcfg
from specinv_tpu_torch import convert


def _fields(cfg):
    return (cfg.n_fft, cfg.hop_length, cfg.center, cfg.pad_mode, cfg.normalized,
            cfg.onesided, cfg.num_freqs, cfg.pad_amount, cfg.fft_norm)


@pytest.mark.parametrize("hop", [None, 128])
@pytest.mark.parametrize("win_length,use_hann", [(None, False), (300, False), (300, True)])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("onesided", [True, False, None])
def test_canonicalize_grid(hop, win_length, use_hann, normalized, onesided):
    window = torch.hann_window(win_length, dtype=torch.float64) if use_hann else None
    bins = 257 if onesided in (True, None) else 512
    kw = dict(hop_length=hop, win_length=win_length, window=window,
              normalized=normalized, onesided=onesided)
    jc, jw = jcfg.canonicalize(bins, np.float64, **kw)
    tc, tw = tcfg.canonicalize(bins, np.float64, **kw)
    assert _fields(tc) == _fields(jc)
    assert tc.num_frames(4410) == jc.num_frames(4410)
    assert tc.output_length(30) == jc.output_length(30)
    np.testing.assert_array_equal(tw, jw)
    assert tw.dtype == jw.dtype


@pytest.mark.parametrize("pad_mode", ["reflect", "constant", "replicate", "circular"])
@pytest.mark.parametrize("center", [True, False])
def test_canonicalize_pad_modes(pad_mode, center):
    jc, _ = jcfg.canonicalize(257, np.float32, center=center, pad_mode=pad_mode)
    tc, _ = tcfg.canonicalize(257, np.float32, center=center, pad_mode=pad_mode)
    assert _fields(tc) == _fields(jc)
    assert tc.torch_pad_mode == pad_mode


def test_complex_window_infers_twosided():
    win = np.exp(1j * np.linspace(0, 1, 64))
    jc, jw = jcfg.canonicalize(64, np.float64, window=win)
    tc, tw = tcfg.canonicalize(64, np.float64, window=torch.from_numpy(win))
    assert _fields(tc) == _fields(jc) and not tc.onesided
    np.testing.assert_array_equal(tw, jw)


def test_errors_match():
    for kw in (dict(pad_mode="bogus"), dict(win_length=1024)):
        with pytest.raises(ValueError):
            jcfg.canonicalize(257, np.float32, **kw)
        with pytest.raises(ValueError):
            tcfg.canonicalize(257, np.float32, **kw)


def test_config_from_fields():
    jc, _ = jcfg.canonicalize(1025, np.float32, hop_length=512, pad_mode="circular")
    tc = convert.config_from_fields(jc.n_fft, jc.hop_length, jc.center, jc.pad_mode,
                                    jc.normalized, jc.onesided)
    assert _fields(tc) == _fields(jc)
