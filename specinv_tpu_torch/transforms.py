"""Public STFT analysis/synthesis wrappers in the reference's layout.

Counterpart of ``specinv_tpu/transforms.py``: ``stft`` matches
``torch.stft(..., return_complex=True)``; ``istft`` is the reference's
``_istft`` synthesis (symmetric trim, not torch.istft's ``length`` logic).
Layout at this boundary is ``(F, T)`` / ``(B, F, T)``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import as_numpy_window, canonicalize
from .ops import dft
from .ops import stft as stft_ops
from .utils.profiling import host_sync


def default_device() -> torch.device:
    """Where an input that is not a tensor goes: the CUDA card.

    A CPU tensor is the caller's way to ask for the CPU; without a card an
    array raises rather than run there unasked.
    """
    if not torch.cuda.is_available():
        raise ValueError(
            "no CUDA card: an array input runs on the card; pass a CPU tensor "
            "(torch.from_numpy) to run on the CPU"
        )
    return torch.device("cuda")


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; anything else as a tensor on :func:`default_device`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=default_device())


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Working real type: the real part of a complex type, float32 for
    16-bit floats and non-float input."""
    if dtype.is_complex:
        return torch.empty((), dtype=dtype).real.dtype
    if dtype in (torch.float32, torch.float64):
        return dtype
    return torch.float32


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy counterpart of a torch float32/float64 dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def window_tensor(window_np: np.ndarray, device, real_dtype: torch.dtype) -> torch.Tensor:
    """Canonical numpy window -> tensor on ``device`` in the working type
    (to a card: a blocking copy, one host sync)."""
    with host_sync(device):
        w = torch.from_numpy(np.ascontiguousarray(window_np)).to(device)
    if w.is_complex():
        return w.to(torch.complex128 if real_dtype == torch.float64 else torch.complex64)
    return w.to(real_dtype)


def stft(x, n_fft: int, backend: str = "auto", precision=None, **stft_kwargs):
    """Complex STFT of ``x`` (..., L) -> (..., F, T), torch.stft semantics.

    ``x`` is a tensor on any device, or an array, which goes to the card.
    ``precision`` follows JAX's rule for its XLA backends: None,
    ``'default'``, ``'high'`` or ``'highest'`` (any case), which
    ``torch.fft`` ignores; anything else raises."""
    dft.check_precision(precision, "fft")
    x = as_tensor(x)
    window = stft_kwargs.get("window")
    complex_in = x.is_complex() or (
        window is not None and np.iscomplexobj(as_numpy_window(window))
    )
    onesided = stft_kwargs.get("onesided")
    if onesided is None:
        onesided = not complex_in
        stft_kwargs = dict(stft_kwargs, onesided=onesided)
    elif onesided and complex_in:
        raise ValueError(
            "onesided=True is impossible with a complex input or window "
            "(the spectrum is not Hermitian); torch.stft raises here too"
        )
    if onesided:
        if n_fft % 2:
            raise ValueError(
                f"onesided STFT needs an even n_fft (got {n_fft}); pass "
                "onesided=False or an even size"
            )
        bins = n_fft // 2 + 1
    else:
        bins = n_fft
    real = _real_dtype(x.dtype)
    cfg, w = canonicalize(bins, numpy_dtype(real), **stft_kwargs)
    if not x.is_floating_point() and not x.is_complex():
        x = x.to(real)
    spec_tm = stft_ops.stft(x, cfg, window_tensor(w, x.device, real), backend=backend)
    return spec_tm.transpose(-1, -2)


def istft(spec, length: Optional[int] = None, backend: str = "auto", precision=None,
          **stft_kwargs):
    """Inverse STFT of complex ``spec`` (..., F, T) -> (..., L_out).

    ``n_fft`` is inferred from the bin count like the inversion entry points;
    ``length`` crops or zero-pads to an exact sample count.  ``spec`` is a
    tensor on any device, or an array, which goes to the card.
    ``precision`` as on :func:`stft`.
    """
    dft.check_precision(precision, "fft")
    spec = as_tensor(spec)
    if not spec.is_complex():
        raise TypeError(
            "istft needs a complex spectrogram; got a real array — invert "
            "magnitudes with griffin_lim instead"
        )
    real = _real_dtype(spec.dtype)
    cfg, w = canonicalize(spec.shape[-2], numpy_dtype(real), **stft_kwargs)
    x = stft_ops.istft(
        spec.transpose(-1, -2), cfg, window_tensor(w, spec.device, real), backend=backend
    )
    if length is not None:
        if x.shape[-1] >= length:
            x = x[..., :length]
        else:
            x = F.pad(x, (0, length - x.shape[-1]))
    return x
