"""Plain STFT pieces that the references share.

Written from the definitions alone (torch.stft's centring, a window^2
overlap-add envelope), in the type of the tensors given.  Every stored
intermediate passes through ``keep``: the identity for a reference run, a
rounding to a lower precision for the control (:func:`bf16_keep`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16_keep(t: torch.Tensor) -> torch.Tensor:
    """Round ``t`` (real or complex) to bfloat16 and back to its type."""
    if t.is_complex():
        return torch.complex(bf16_keep(t.real), bf16_keep(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)


def frames_of(x: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """``(..., L)`` -> overlapping frames ``(..., T, n)``."""
    return x.unfold(-1, n, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """``(..., T, n)`` -> ``(..., (T - 1) * hop + n)`` by a sum of shifted rows."""
    *lead, T, n = frames.shape
    k = -(-n // hop)
    frames = F.pad(frames, (0, k * hop - n))
    total = (T - 1 + k) * hop
    out = frames.new_zeros((*lead, total))
    for j in range(k):  # chunk j of frame t lands at (t + j) * hop
        chunk = frames[..., j * hop : (j + 1) * hop].reshape(*lead, T * hop)
        out[..., j * hop : j * hop + T * hop] += chunk
    return out[..., : (T - 1) * hop + n]


def rfft(frames: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfft(frames, dim=-1)


def irfft(spec: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of a onesided spectrum; the imaginary parts of the DC and
    Nyquist bins are taken as zero, as a real signal's are."""
    im = spec.imag.clone()
    im[..., 0] = 0
    im[..., -1] = 0
    return torch.fft.irfft(torch.complex(spec.real, im), n=n, dim=-1)


def stft(x: torch.Tensor, window: torch.Tensor, hop: int, keep=identity) -> torch.Tensor:
    """Centred (reflect) analysis: ``(B, L)`` -> ``(B, T, F)``."""
    n = window.shape[-1]
    pad = F.pad(x[:, None], (n // 2, n // 2), mode="reflect")[:, 0]
    return keep(rfft(keep(frames_of(pad, n, hop) * window)))


def envelope(window: torch.Tensor, T: int, hop: int) -> torch.Tensor:
    """The window^2 overlap-add envelope over ``T`` frames, zeros taken as 1."""
    env = overlap_add((window * window).expand(T, -1), hop)
    return torch.where(env == 0, torch.ones_like(env), env)


def istft(spec: torch.Tensor, window: torch.Tensor, hop: int, keep=identity) -> torch.Tensor:
    """Synthesis with the window^2 envelope and the centre trim:
    ``(B, T, F)`` -> ``(B, (T - 1) * hop)``."""
    n = window.shape[-1]
    T = spec.shape[-2]
    y = keep(overlap_add(keep(irfft(spec, n)) * window, hop)) / envelope(window, T, hop)
    return keep(y[..., n // 2 : y.shape[-1] - n // 2])
