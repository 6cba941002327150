"""Deterministic speech-like test corpus (no external audio, no egress).

A copy of ``specinv_tpu/utils/corpus.py``: the port imports no JAX package,
and this module is plain numpy, so both packages make the same clip.

White noise is the EASIEST case for magnitude-only inversion (its phase
carries no structure to recover); the reference demo inverts a real
recording (torch_specinv's main.py).  Real audio cannot ship with
this repo, so quality validation uses a reproducible source-filter
synthesis with the properties that actually stress phase retrieval:

  * harmonic structure with a moving pitch contour (phase coherence across
    partials matters),
  * time-varying formant envelopes (non-stationary spectra),
  * syllable-rate amplitude gating with voiced/unvoiced alternation,
  * fricative noise bands and stop-like transients (broadband onsets are
    where Griffin-Lim smearing is audible).

Everything is seeded numpy float64 — bit-reproducible across runs and
platforms — so golden trajectories pinned on this corpus are stable.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_speech_like"]


def _smoothstep(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def make_speech_like(
    n_samples: int,
    sr: float = 22050.0,
    seed: int = 0,
    n_harmonics: int = 40,
    dtype=np.float64,
) -> np.ndarray:
    """Synthesize a speech-like clip of ``n_samples`` samples.

    Source-filter model: a harmonic source with a slow pitch vibrato whose
    partials are shaped by three moving formant resonance bumps, gated at
    syllable rate; unvoiced gaps carry band-limited fricative noise; each
    voiced onset gets a stop-like click.  Peak-normalized to 0.9.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float64) / sr

    # pitch contour: 120 Hz base, +-3 semitones of slow movement
    f0 = 120.0 * 2.0 ** (
        0.25 * np.sin(2 * np.pi * 0.7 * t) + 0.1 * np.sin(2 * np.pi * 2.3 * t)
    )
    phase0 = 2 * np.pi * np.cumsum(f0) / sr

    # moving formants (center Hz, bandwidth Hz)
    f1 = 450.0 + 250.0 * np.sin(2 * np.pi * 1.1 * t + 0.5)
    f2 = 1500.0 + 500.0 * np.sin(2 * np.pi * 0.9 * t + 2.1)
    f3 = np.full_like(t, 2600.0)
    bw = (120.0, 220.0, 300.0)

    voiced = np.zeros_like(t)
    for k in range(1, n_harmonics + 1):
        fk = k * f0
        amp = (
            np.exp(-0.5 * ((fk - f1) / bw[0]) ** 2)
            + 0.6 * np.exp(-0.5 * ((fk - f2) / bw[1]) ** 2)
            + 0.3 * np.exp(-0.5 * ((fk - f3) / bw[2]) ** 2)
        ) / k**0.3
        amp = np.where(fk < 0.45 * sr, amp, 0.0)  # keep clear of Nyquist
        voiced += amp * np.sin(k * phase0 + 0.1 * k * k)  # dispersed onsets

    # syllable gate at ~3.5 Hz: voiced when gate > 0, smooth 15 ms edges
    gate_sig = np.sin(2 * np.pi * 3.5 * t + 0.3)
    edge = 0.015 * sr
    gate = _smoothstep((gate_sig - 0.0) / (edge / sr * 2 * np.pi * 3.5))
    voiced *= gate

    # fricative noise in the unvoiced gaps: 3-8 kHz band (FFT brickband)
    noise = rng.standard_normal(n_samples)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n_samples, 1.0 / sr)
    band = (freqs > 3000.0) & (freqs < 8000.0)
    fric = np.fft.irfft(spec * band, n_samples)
    fric *= (1.0 - gate) * 0.35

    # stop-like clicks at voiced onsets: short decaying broadband bursts
    onsets = np.flatnonzero((gate[1:] > 0.5) & (gate[:-1] <= 0.5))
    clicks = np.zeros_like(t)
    klen = int(0.004 * sr)
    kernel = rng.standard_normal(klen) * np.exp(
        -np.arange(klen) / (0.001 * sr)
    )
    for o in onsets:
        end = min(o + klen, n_samples)
        clicks[o:end] += kernel[: end - o]
    clicks *= 1.2

    x = voiced + fric + clicks
    x = x / np.max(np.abs(x)) * 0.9
    return x.astype(dtype)
