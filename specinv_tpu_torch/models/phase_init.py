"""SPSI-style phase initialization (dense rewrite) on torch tensors.

Counterpart of ``specinv_tpu/models/phase_init.py``: peaks are strict local
maxima along frequency, their true frequency is quadratically interpolated,
and the instantaneous angular increment is written into the peak bin and its
two neighbours before a cumulative sum over time.  The reference's three
sequential scatter writes (peak, peak-1, peak+1) have overwrite semantics,
so the dense form is a priority select: a bin one above a peak wins, then
one below, then the peak itself.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import STFTConfig
from .common import as_tensor, prepare_spec_b3

_PI2 = 2.0 * math.pi


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """x[f] -> x[f-1] (zero at f=0)."""
    return F.pad(x[..., :-1], (1, 0))


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """x[f] -> x[f+1] (zero at the top bin)."""
    return F.pad(x[..., 1:], (0, 1))


def phase_init_tm(spec_tm: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Time-major core: magnitude ``(..., T, F)`` -> complex ``(..., T, F)``."""
    s = spec_tm
    if s.dtype in (torch.bfloat16, torch.float16):
        s = s.float()
    interior = (s[..., 1:-1] > s[..., 2:]) & (s[..., 1:-1] > s[..., :-2])
    mask = F.pad(interior, (1, 1))

    a = _shift_down(s)
    r = _shift_up(s)
    denom = a - 2 * s + r
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    p = 0.5 * (a - r) / denom

    freqs = torch.arange(s.shape[-1], dtype=s.dtype, device=s.device)
    omega = _PI2 * (freqs + p) / cfg.n_fft * cfg.hop_length
    omega = torch.where(mask, omega, torch.zeros_like(omega))

    increment = torch.where(
        _shift_down(mask),
        _shift_down(omega),
        torch.where(_shift_up(mask), _shift_up(omega), omega),
    )
    phase = torch.cumsum(increment, dim=-2)
    return torch.polar(s, phase)


def phase_init(spec, **stft_kwargs) -> torch.Tensor:
    """Reference-parity wrapper: magnitude ``(F, T)``/``(B, F, T)`` ->
    complex spectrogram in the same layout."""
    spec = as_tensor(spec)
    if spec.is_complex():
        raise ValueError("phase_init expects a magnitude (real) spectrogram")
    shape = spec.shape
    spec_b3, _was_2d, cfg, _window = prepare_spec_b3(spec, **stft_kwargs)
    out_tm = phase_init_tm(spec_b3.transpose(-1, -2), cfg)
    return out_tm.transpose(-1, -2).reshape(shape)
