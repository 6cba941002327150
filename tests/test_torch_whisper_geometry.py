"""Whisper's 16 kHz STFT (n_fft 400, hop 160, periodic hann, centred) on the
direct-DFT Griffin-Lim path, the benchmark's ``gl400_16k`` configuration.

``'auto'`` takes kernel E there on a card (n_fft 400 is no power of two),
decided from the config alone; on the CPU ``backend='dft'`` runs the
kernel's plain version, which is held here to the benchmark's float64
reference (``portbench/reference/griffin_lim.py``) over 100 iterations on
two 1 s speech-like clips at 16 kHz.
"""
import numpy as np
import pytest
import torch

import specinv_tpu_torch as st
from portbench.checks.gl_output import sc_db
from portbench.inputs import hann
from portbench.reference import griffin_lim as reference
from portbench.reference._signal import stft
from specinv_tpu_torch.config import canonicalize
from specinv_tpu_torch.models.common import resolve_backend
from specinv_tpu_torch.utils.corpus import make_speech_like

SR, N_FFT, HOP = 16000, 400, 160

# Per clip, against the float64 reference from the same magnitudes.  The
# float32 SPSI seed's phase sums over the clip's 101 frames put the float32
# paths 0.2-1.7 % from float64 in waveform ('high' and 'highest' alike) and
# up to 1e-3 dB in spectral convergence; one bf16 product per transform
# ('default') reads 6.8-7.3 % and 0.04-0.05 dB, so each tolerance is 2.4x
# and 10x above the float32 paths and 1.7x and 4x below 'default'.
WAVE_DIST = 0.04
SC_GAP_DB = 0.01


@pytest.mark.parametrize("n_fft,hop,expected", [(400, 160, "dft"), (2048, 512, "kernel")])
def test_auto_resolves_from_the_config_without_a_card(n_fft, hop, expected):
    """Whisper's geometry takes kernel E ('dft'), config 1's kernel A
    ('kernel'); a CPU tensor takes 'fft'."""
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    cfg, w = canonicalize(n_fft // 2 + 1, np.float32, window=win, hop_length=hop)
    assert resolve_backend("auto", cfg, w, torch.device("cuda")) == expected
    assert resolve_backend("auto", cfg, w, torch.device("cpu")) == "fft"


@pytest.fixture(scope="module")
def whisper_case():
    """Two 1 s clips' float32 magnitudes (B, 201, 101) and the float64
    reference's waveforms and spectral convergence from them."""
    w32, w64 = hann(N_FFT, "cpu")
    clips = torch.from_numpy(np.stack([make_speech_like(SR, sr=SR, seed=s) for s in (3, 4)]))
    mag = stft(clips, w64, HOP).abs().transpose(-1, -2).float().contiguous()
    y64 = reference.invert(mag.double(), w64, HOP, max_iter=100, tol=1e-6, eva_iter=10,
                           alpha=0.99)
    target = mag.double().transpose(-1, -2)
    return mag, w32, w64, y64, target, sc_db(y64, target, w64, HOP)


@pytest.mark.parametrize("precision,within", [("high", True), ("highest", True),
                                              ("default", False)])
def test_dft_path_matches_the_float64_reference(whisper_case, precision, within):
    """'high' (the entry's default on 'dft') and 'highest' lie within both
    tolerances of the float64 reference; 'default' fails at least one."""
    mag, w32, w64, y64, target, sc_ref = whisper_case
    y = st.griffin_lim(mag, max_iter=100, backend="dft", precision=precision, window=w32,
                       hop_length=HOP, verbose=False)
    assert y.shape == y64.shape == (2, 100 * HOP)
    dist = ((y.double() - y64).norm(dim=1) / y64.norm(dim=1)).max().item()
    gap = max(abs(a - b) for a, b in zip(sc_db(y, target, w64, HOP), sc_ref))
    assert (dist <= WAVE_DIST and gap <= SC_GAP_DB) is within, (dist, gap)
