"""Shared wrapper plumbing for the public (reference-parity) algorithm API.

Counterpart of ``specinv_tpu/models/common.py``: inputs are ``(F, T)`` or
``(B, F, T)`` spectrograms; outputs squeeze the batch dim back off unless the
caller passed a 3-D batch-1 input.  Internally everything runs time-major
``(B, T, F)``.  The argument checks and the backend rule that
``griffin_lim`` and ``ADMM`` both follow live here too.
"""
from __future__ import annotations

import numbers
from typing import Any, Tuple

import torch

from ..config import STFT_KWARG_NAMES, STFTConfig, canonicalize
from ..ops import dft, fourier
from ..ops.cuda import _dft, _fullrun
from ..transforms import _real_dtype, as_tensor, numpy_dtype, window_tensor
from ..utils.runner import stop_loss_fn

BACKENDS = ("auto", "kernel", "dft", "fft")


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


def time_major(spec_b3: torch.Tensor) -> torch.Tensor:
    """The ``(B, T, F)`` view the drivers take, 16-bit floats as float32."""
    if spec_b3.dtype in (torch.bfloat16, torch.float16):
        spec_b3 = spec_b3.float()
    return spec_b3.transpose(-1, -2)


def resolve_backend(backend: str, cfg: STFTConfig, window, device,
                    is_complex: bool = False) -> str:
    """``'auto'`` on CUDA -> ``'kernel'`` when the whole-run kernels take
    ``cfg``, else ``'dft'`` when the direct-DFT kernels take it and the
    spectrogram is real (``is_complex`` False), else ``'fft'``; on the CPU
    ``'fft'``.  Decided from the config, before any launch.  Shared by
    ``griffin_lim`` and ``ADMM``."""
    fourier.check_not_xla_lowering(backend, direct_dft=True)
    if backend in ("pallas", "pallas4"):
        raise ValueError(
            f"backend {backend!r} is a TPU kernel; the port's counterparts are 'dft' "
            "(JAX 'pallas') and 'kernel' (JAX 'pallas4')")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    ok, dft_ok = _fullrun.supports(cfg, window), _dft.supports(cfg, window)
    if backend == "auto":
        if device.type != "cuda":
            return "fft"
        return "kernel" if ok else ("dft" if dft_ok and not is_complex else "fft")
    if backend == "kernel" and not ok:
        raise ValueError(
            f"the kernel backend needs {_fullrun.UNSUPPORTED}; use backend='auto' instead"
        )
    if backend == "dft" and not dft_ok:
        raise ValueError(
            f"the dft backend needs {_dft.UNSUPPORTED}; use backend='auto' instead"
        )
    return backend


def check_args(stft_kwargs, loss_psum_axes) -> None:
    """The backend-free argument checks ``griffin_lim`` and ``ADMM`` share.
    ``loss_psum_axes`` must name axes of the mesh the caller bound
    (``parallel.batched``)."""
    unknown = set(stft_kwargs) - set(STFT_KWARG_NAMES)
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    stop_loss_fn(loss_psum_axes)


def check_pack(pack, backend: str, batch: int) -> None:
    """JAX's rule for ``pack`` on the resolved backend.  The TPU kernel
    folds ``pack`` clips into each grid step, bitwise invariant; here one
    launch already covers every clip, so on ``'kernel'`` (the JAX
    ``'pallas4'``) a valid ``pack`` changes nothing.  Elsewhere it raises."""
    if pack is None:
        return
    if backend != "kernel":
        raise ValueError(
            f"pack applies to the whole-run pallas4 kernel only (the port's 'kernel'; "
            f"resolved backend here: {backend!r})"
        )
    if isinstance(pack, bool) or not isinstance(pack, numbers.Integral) or pack < 1 or batch % pack:
        raise ValueError(f"pack={pack} must be >= 1 and divide the batch size {batch}")


def prepare(spec, backend: str, precision, pack, loss_psum_axes, stft_kwargs):
    """The argument checks and input preparation ``griffin_lim`` and
    ``ADMM`` share -> ``(spec_tm, was_2d, cfg, window, backend,
    precision)``, the backend resolved and the precision checked on it."""
    check_args(stft_kwargs, loss_psum_axes)
    spec_b3, was_2d, cfg, window = prepare_spec_b3(spec, **stft_kwargs)
    backend = resolve_backend(backend, cfg, window, spec_b3.device, spec_b3.is_complex())
    check_pack(pack, backend, spec_b3.shape[0])
    precision = dft.check_precision(precision, backend)
    return time_major(spec_b3), was_2d, cfg, window, backend, precision
