"""Seeded speech-like clips, made on the card in float64.

The formula and parameters of ``specinv_tpu_torch/utils/corpus.py``'s
``make_speech_like`` (a harmonic source with a slow pitch vibrato under
three moving formants, gated at syllable rate, band-limited fricative noise
in the unvoiced gaps, a stop-like click at each voiced onset, peak
normalised to 0.9), written in PyTorch so that a batch of clips is a few
large calls on the device.  The random draws come from one
``torch.Generator`` on the clips' device seeded with ``seed``: the same seed
gives the same clips there, but not numpy's clips of the same seed.
"""
from __future__ import annotations

import math

import torch

SR = 22050.0
N_HARMONICS = 40


def _smoothstep(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def clips(count: int, n_samples: int, seed: int, device, sr: float = SR) -> torch.Tensor:
    """``count`` distinct clips ``(count, n_samples)``, float64 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(n_samples, **f64) / sr

    # pitch contour: 120 Hz base, +-3 semitones of slow movement
    f0 = 120.0 * 2.0 ** (0.25 * torch.sin(2 * math.pi * 0.7 * t)
                         + 0.1 * torch.sin(2 * math.pi * 2.3 * t))
    phase0 = 2 * math.pi * torch.cumsum(f0, 0) / sr

    # moving formants (centre Hz) and their bandwidths (Hz)
    f1 = 450.0 + 250.0 * torch.sin(2 * math.pi * 1.1 * t + 0.5)
    f2 = 1500.0 + 500.0 * torch.sin(2 * math.pi * 0.9 * t + 2.1)
    f3 = 2600.0
    bw = (120.0, 220.0, 300.0)
    k = torch.arange(1, N_HARMONICS + 1, **f64)[:, None]
    fk = k * f0
    amp = (torch.exp(-0.5 * ((fk - f1) / bw[0]) ** 2)
           + 0.6 * torch.exp(-0.5 * ((fk - f2) / bw[1]) ** 2)
           + 0.3 * torch.exp(-0.5 * ((fk - f3) / bw[2]) ** 2)) / k ** 0.3
    amp = torch.where(fk < 0.45 * sr, amp, torch.zeros_like(amp))  # clear of Nyquist
    voiced = (amp * torch.sin(k * phase0 + 0.1 * k * k)).sum(0)     # dispersed onsets

    # syllable gate at 3.5 Hz: voiced where the gate is up, smooth 15 ms edges
    edge = 0.015 * sr
    gate = _smoothstep(torch.sin(2 * math.pi * 3.5 * t + 0.3) / (edge / sr * 2 * math.pi * 3.5))
    voiced = voiced * gate

    # fricative noise in the unvoiced gaps: the 3-8 kHz band of white noise
    noise = torch.randn((count, n_samples), generator=gen, **f64)
    freqs = torch.fft.rfftfreq(n_samples, 1.0 / sr, **f64)
    band = ((freqs > 3000.0) & (freqs < 8000.0)).to(torch.float64)
    fric = torch.fft.irfft(torch.fft.rfft(noise, dim=-1) * band, n_samples, dim=-1)
    fric = fric * (1.0 - gate) * 0.35

    # stop-like clicks at voiced onsets: short decaying bursts, one per clip
    klen = int(0.004 * sr)
    kernel = torch.randn((count, klen), generator=gen, **f64) * torch.exp(
        -torch.arange(klen, **f64) / (0.001 * sr))
    onsets = torch.nonzero((gate[1:] > 0.5) & (gate[:-1] <= 0.5)).flatten()
    at = onsets[:, None] + torch.arange(klen, device=device)            # (onsets, klen)
    inside = at < n_samples  # onsets lie 0.29 s apart, so no two bursts overlap
    clicks = torch.zeros((count, n_samples), **f64)
    clicks[:, at[inside]] = kernel[:, None, :].expand(-1, len(onsets), -1)[:, inside]
    clicks = clicks * 1.2

    x = voiced + fric + clicks
    return x / x.abs().amax(dim=-1, keepdim=True) * 0.9
