"""Kernel B: the device FFT of ``csrc/rfft.cuh``, its plain version and its
launch count.

The half-length real FFT of ``csrc/rfft.cuh`` (FP64) replaces the TPU
four-step transform ``specinv_tpu/ops/pallas/fft4.py`` (``fwd4_lane``,
``inv4_real_lane``).  The whole-run kernels A and C inline it
(``csrc/fullrun.cuh``); :func:`fft` and :func:`ifft` launch it on its own
(``csrc/fft.cu``), laid out as A and C lay it out, so that it can be held
against :func:`fft_reference` and :func:`ifft_reference`.  On a CPU tensor
the wrappers run the plain version; on a CUDA tensor they launch the kernel
or raise.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...utils.profiling import host_sync
from . import _build

MIN_N, MAX_N = 16, 4096

# Launches of the stand-alone FFT kernels (the Griffin-Lim kernel counts its
# own, in gl_fullrun.launches).
launches = 0


def supported_size(n: int) -> bool:
    return MIN_N <= n <= MAX_N and n & (n - 1) == 0


@functools.lru_cache(maxsize=None)
def twiddles(n: int, device: torch.device, dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """exp(-2*pi*i*k/n), k < n/2, computed in float64, stored as ``dtype``
    (complex128 for the FP64 transform of ``csrc/rfft.cuh``, which every
    kernel that reads the table runs).  Any even ``n``: the mixed-radix
    stages read exp(-2*pi*i*m/h), h = n/2, as entry 2m, or minus entry
    2m - h past a half turn, as the power-of-two ones do.

    Cached per device: a fresh host-to-device copy per launch would make
    every launch wait for the host.
    """
    k = np.arange(n // 2)
    with host_sync(device):
        return torch.from_numpy(np.exp(-2j * np.pi * k / n)).to(dtype).to(device)


def scales(n: int, normalized: bool):
    """(forward, inverse) scale: (1, 1/n), or (1/sqrt(n), 1/sqrt(n))."""
    if normalized:
        return 1.0 / math.sqrt(n), 1.0 / math.sqrt(n)
    return 1.0, 1.0 / n


def fft_reference(frames: torch.Tensor, normalized: bool = False,
                  onesided: bool = True) -> torch.Tensor:
    """Plain version: real frames (R, n) -> spectrum (R, n/2+1) or (R, n)."""
    norm = "ortho" if normalized else None
    if onesided:
        return torch.fft.rfft(frames, dim=-1, norm=norm)
    return torch.fft.fft(frames, dim=-1, norm=norm)


def ifft_reference(spec: torch.Tensor, n: int, normalized: bool = False,
                   onesided: bool = True) -> torch.Tensor:
    """Plain version: spectrum -> real part of the inverse DFT (R, n)."""
    norm = "ortho" if normalized else None
    if onesided:
        return torch.fft.irfft(spec, n=n, dim=-1, norm=norm)
    return torch.fft.ifft(spec, n=n, dim=-1, norm=norm).real


def _check(t: torch.Tensor, dtype: torch.dtype, n: int) -> None:
    if t.dtype != dtype or t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"expected a contiguous 2-D {dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    if not supported_size(n):
        raise ValueError(f"the device FFT takes n a power of two in [{MIN_N}, {MAX_N}], got {n}")


def fft(frames: torch.Tensor, normalized: bool = False, onesided: bool = True) -> torch.Tensor:
    """Forward DFT of real frames (R, n) float32 along the last axis."""
    if frames.device.type == "cpu":
        return fft_reference(frames, normalized, onesided)
    global launches
    rows, n = frames.shape
    _check(frames, torch.float32, n)
    n_bins = n // 2 + 1 if onesided else n
    out = torch.empty((rows, n_bins), dtype=torch.complex64, device=frames.device)
    lib = _build.library()
    launches += 1
    code = lib.specinv_fft_r2c(
        frames.data_ptr(), out.data_ptr(), twiddles(n, frames.device, torch.complex128).data_ptr(),
        rows, n, n.bit_length() - 1, n_bins, scales(n, normalized)[0],
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _build.check(code, "specinv_fft_r2c")
    return out


def ifft(spec: torch.Tensor, n: int, normalized: bool = False, onesided: bool = True) -> torch.Tensor:
    """Real part of the inverse DFT of complex64 spectra (R, n_bins) -> (R, n)."""
    if spec.device.type == "cpu":
        return ifft_reference(spec, n, normalized, onesided)
    global launches
    rows, n_bins = spec.shape
    _check(spec, torch.complex64, n)
    if n_bins != (n // 2 + 1 if onesided else n):
        raise ValueError(f"{n_bins} bins do not fit n={n}, onesided={onesided}")
    out = torch.empty((rows, n), dtype=torch.float32, device=spec.device)
    lib = _build.library()
    launches += 1
    code = lib.specinv_fft_c2r(
        spec.data_ptr(), out.data_ptr(), twiddles(n, spec.device, torch.complex128).data_ptr(),
        rows, n, n.bit_length() - 1, n_bins, int(onesided), scales(n, normalized)[1],
        torch.cuda.current_stream(spec.device).cuda_stream,
    )
    _build.check(code, "specinv_fft_c2r")
    return out
