"""Fourier transforms along the frame axis on ``torch.fft``.

Counterpart of the ``fft`` backend of ``specinv_tpu/ops/fourier.py``: frames
``(..., T, n_fft)`` <-> spectra ``(..., T, F)``, onesided or two-sided,
``normalized`` as ``norm='ortho'``.  The JAX package's matmul and four-step
DFT backends and its measured crossover policy are TPU lowerings and are not
part of the port; ``'auto'`` is ``'fft'`` here.

The library-wide precision knob (:func:`default_precision`,
:func:`set_default_precision`) is the JAX package's, with the values
``'default'`` (one bf16 pass), ``'high'`` (three bf16 passes, the default)
and ``'highest'`` (float32).  In the port it governs only the direct-DFT
backend ``'dft'`` of ``griffin_lim`` and ``ADMM`` (``ops/dft.py``); the
transforms here and the ``'kernel'`` and ``'fft'`` backends always compute
in the input's precision.
"""
from __future__ import annotations

import torch

from ..config import STFTConfig
from ..utils.profiling import host_sync

VALID_DFT_BACKENDS = ("auto", "fft")
# The JAX package's XLA lowerings of the DFT (its fourier.VALID_DFT_BACKENDS
# beside 'fft'), which the port does not have
XLA_DFT_BACKENDS = ("matmul", "matmul4")
PRECISIONS = ("default", "high", "highest")

_DEFAULT_PRECISION = "high"


def set_default_precision(p: str) -> None:
    """Set the default precision of the direct-DFT backend: one of
    'default' | 'high' | 'highest' (any case)."""
    global _DEFAULT_PRECISION
    name = str(p).lower()
    if name not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {p!r}")
    _DEFAULT_PRECISION = name


def default_precision() -> str:
    return _DEFAULT_PRECISION


def check_not_xla_lowering(backend, direct_dft: bool = False) -> None:
    """Raise for a JAX XLA lowering of the DFT (``'matmul'``, ``'matmul4'``),
    naming the port's counterpart: ``'fft'``, and ``'dft'`` where the entry
    point has the direct DFT (``direct_dft``).  No entry point runs another
    path in its place (the JAX package's rule: no silent backend
    downgrades)."""
    if backend in XLA_DFT_BACKENDS:
        also = ", or 'dft' for the direct DFT as products" if direct_dft else ""
        raise ValueError(
            f"backend {backend!r} is an XLA lowering of the DFT that the port does not "
            f"have; the port's counterpart is 'fft' (same DFT){also}")


def resolve_backend(backend: str) -> str:
    check_not_xla_lowering(backend)
    if backend not in VALID_DFT_BACKENDS:
        raise ValueError(
            f"unknown DFT backend {backend!r}; expected one of {VALID_DFT_BACKENDS}"
        )
    return "fft"


def _compute_dtype(t: torch.Tensor) -> torch.Tensor:
    # torch.fft has no bf16/fp16 CPU kernels: compute half types in float32
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


def forward(frames: torch.Tensor, cfg: STFTConfig, backend: str = "auto") -> torch.Tensor:
    """DFT along the last axis of windowed frames -> complex (..., T, F)."""
    resolve_backend(backend)
    frames = _compute_dtype(frames)
    if cfg.onesided and not frames.is_complex():
        return torch.fft.rfft(frames, n=cfg.n_fft, dim=-1, norm=cfg.fft_norm)
    return torch.fft.fft(frames, n=cfg.n_fft, dim=-1, norm=cfg.fft_norm)


# (F, 2) masks of _real_ends per (bins, even n, device, dtype)
_ENDS_MASKS: dict = {}


def _real_ends(spec: torch.Tensor, n: int) -> torch.Tensor:
    """``spec`` with the imaginary parts of its DC and (``n`` even) Nyquist
    bins zeroed, in one multiply by a cached mask.  The real inverse of a
    Hermitian-completed spectrum reads only their real parts, as the CPU's
    ``irfft`` and the kernels do; cuFFT's complex-to-real transform assumes
    them real, and where they are not (a momentum state, a phase seed) its
    float32 result depends on them at some batch sizes (chip_smoke.py phase
    3 prints how far, at 431 and at 12922 frames of n_fft 2048)."""
    bins = spec.shape[-1]
    key = (bins, n % 2 == 0 and bins == n // 2 + 1, spec.device, spec.real.dtype)
    mask = _ENDS_MASKS.get(key)
    if mask is None:
        mask = torch.ones((bins, 2), dtype=key[3], device=spec.device)
        with host_sync(mask):  # an element set from the host: a blocking copy
            mask[0, 1] = 0
        if key[1]:
            with host_sync(mask):
                mask[-1, 1] = 0
        _ENDS_MASKS[key] = mask
    return torch.view_as_complex(torch.view_as_real(spec) * mask)


def inverse(spec: torch.Tensor, cfg: STFTConfig, backend: str = "auto") -> torch.Tensor:
    """Real part of the inverse DFT -> real frames (..., T, n_fft).  On the
    card the onesided inverse zeroes the imaginary parts of the DC and
    Nyquist bins first (:func:`_real_ends`); the CPU's ``irfft`` never reads
    them."""
    resolve_backend(backend)
    if cfg.onesided:
        if spec.is_cuda:
            spec = _real_ends(spec, cfg.n_fft)
        return torch.fft.irfft(spec, n=cfg.n_fft, dim=-1, norm=cfg.fft_norm)
    return torch.fft.ifft(spec, n=cfg.n_fft, dim=-1, norm=cfg.fft_norm).real
