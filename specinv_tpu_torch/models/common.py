"""Shared wrapper plumbing for the public (reference-parity) algorithm API.

Counterpart of ``specinv_tpu/models/common.py``: inputs are ``(F, T)`` or
``(B, F, T)`` spectrograms; outputs squeeze the batch dim back off unless the
caller passed a 3-D batch-1 input.  Internally everything runs time-major
``(B, T, F)``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..config import STFTConfig, canonicalize
from ..transforms import _real_dtype, as_tensor, numpy_dtype, window_tensor


def prepare_spec_b3(
    spec: Any, **stft_kwargs
) -> Tuple[torch.Tensor, bool, STFTConfig, torch.Tensor]:
    """Canonicalize a user spectrogram without changing its layout.

    Returns ``(spec_b3, was_2d, cfg, window)``: the batched ``(B, F, T)``
    tensor (complex or magnitude, as given), the batch-squeeze flag, the
    config, and the window on the spectrogram's device in its real type.
    """
    spec = as_tensor(spec)
    if not 1 < spec.ndim < 4:
        raise ValueError(f"spec must be 2-D (F,T) or 3-D (B,F,T); got rank {spec.ndim}")
    was_2d = spec.ndim == 2
    if was_2d:
        spec = spec[None]
    real = _real_dtype(spec.dtype)
    cfg, window_np = canonicalize(spec.shape[-2], numpy_dtype(real), **stft_kwargs)
    return spec, was_2d, cfg, window_tensor(window_np, spec.device, real)


def prepare_spec(
    spec: Any, **stft_kwargs
) -> Tuple[torch.Tensor, bool, STFTConfig, torch.Tensor]:
    """Canonicalize a user spectrogram into the time-major layout.

    Returns ``(spec_tm, was_2d, cfg, window)`` where ``spec_tm`` is the
    ``(B, T, F)`` view (complex or magnitude, as given).
    """
    spec, was_2d, cfg, window = prepare_spec_b3(spec, **stft_kwargs)
    return spec.transpose(-1, -2), was_2d, cfg, window


def restore_output(x: torch.Tensor, was_2d: bool) -> torch.Tensor:
    """Apply the reference's batch-squeeze rule to a (B, L) waveform."""
    if was_2d and x.shape[0] == 1:
        return x[0]
    return x
