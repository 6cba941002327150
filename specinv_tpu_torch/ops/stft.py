"""STFT analysis / synthesis in time-major layout on torch tensors.

Counterpart of ``specinv_tpu/ops/stft.py``:

* analysis  = center-pad -> framing -> window -> DFT
* synthesis = inverse DFT -> synthesis window -> overlap-add
              -> symmetric center trim -> window^2 envelope divide

Exact envelope zeros (e.g. a hann window with ``center=False``) are replaced
by 1, as in the JAX package; where ``istft`` builds the envelope itself it
also warns, with the message of the zero-envelope check that it plants
(``utils/guards``: raised inside ``debug_checks()``, as the JAX package's).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..config import STFTConfig
from ..utils import guards
from ..utils.profiling import host_sync
from . import fourier
from .framing import frame, ola_envelope, overlap_add, pad_center

ZERO_ENVELOPE_MSG = (
    "OLA envelope contains zeros (window/hop combination leaves gaps; "
    "the torch reference would emit inf/NaN here)"
)


def stft(
    x: torch.Tensor, cfg: STFTConfig, window: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """Analysis STFT of ``x`` (..., L) -> complex spectrogram (..., T, F)."""
    x = pad_center(x, cfg)
    frames = frame(x, cfg.n_fft, cfg.hop_length) * window
    return fourier.forward(frames, cfg, backend=backend)


def make_envelope(
    cfg: STFTConfig, window: torch.Tensor, num_frames: int
) -> torch.Tensor:
    """Trimmed window^2 OLA envelope of shape (output_length,)."""
    win_sq = (window * window.conj()).real if window.is_complex() else window * window
    env = ola_envelope(win_sq, num_frames, cfg.hop_length)
    p = cfg.pad_amount
    if p:
        env = env[p:-p]
    return env


def istft(
    spec: torch.Tensor,
    cfg: STFTConfig,
    window: torch.Tensor,
    envelope: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Synthesis ISTFT of complex ``spec`` (..., T, F) -> signal (..., L_out).

    ``L_out = (T-1)*hop + n_fft - 2*pad_amount``: the reference's symmetric
    conv-transpose trim, not torch.istft's length logic.
    """
    frames = fourier.inverse(spec, cfg, backend=backend)
    synth_window = window.real if window.is_complex() else window
    x = overlap_add(frames * synth_window, cfg.hop_length)
    p = cfg.pad_amount
    if p:
        x = x[..., p:-p]
    if envelope is None:
        envelope = make_envelope(cfg, window, spec.shape[-2])
        with host_sync(envelope):  # the check reads the card's envelope back
            zeros = bool((envelope == 0).any())
        if zeros:
            warnings.warn(ZERO_ENVELOPE_MSG, RuntimeWarning, stacklevel=2)
    if guards.debug_checks_enabled():
        guards.check((envelope != 0).all(), ZERO_ENVELOPE_MSG)
    envelope = torch.where(envelope == 0, torch.ones_like(envelope), envelope)
    return x / envelope
