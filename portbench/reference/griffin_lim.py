"""Plain Griffin-Lim with the SPSI phase seed, the benchmark's reference.

The algorithm of torch_specinv's ``griffin_lim`` (fast Griffin-Lim with
momentum ``alpha / (1 + alpha)``, projection epsilon 1e-16, the
pre-momentum magnitude as the stop rule's output) started from the SPSI
seed (peaks are strict local maxima along frequency, their frequency
interpolated quadratically, the phase advance written into the peak bin and
its two neighbours, a bin above a peak winning over one below, then summed
over time).  The stop rule: every ``eva_iter`` iterations the mean squared
distance of the magnitude from the target; the first sets the scale, and
the run stops when ``(previous - current) / first < tol`` while the loss
still falls, keeping the state after that iteration.  The loss is the mean
over the whole batch, as a batched call computes it.

It imports nothing of the program and computes in the type of ``mag``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._signal import identity, istft, stft

PROJ_EPS = 1e-16


def spsi(mag_tm: torch.Tensor, n_fft: int, hop: int, keep=identity) -> torch.Tensor:
    """The SPSI phase of a magnitude ``(B, T, F)``; with a rounding ``keep``
    every partial sum over time is rounded."""
    s = mag_tm
    below = F.pad(s[..., :-1], (1, 0))   # s[f - 1]
    above = F.pad(s[..., 1:], (0, 1))    # s[f + 1]
    peak = F.pad((s[..., 1:-1] > s[..., 2:]) & (s[..., 1:-1] > s[..., :-2]), (1, 1))
    denom = below - 2 * s + above
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    shift = 0.5 * (below - above) / denom
    bins = torch.arange(s.shape[-1], dtype=s.dtype, device=s.device)
    omega = torch.where(peak, 2 * math.pi * (bins + shift) / n_fft * hop, torch.zeros_like(s))
    peak_below = F.pad(peak[..., :-1], (1, 0))   # bin f - 1 is a peak
    peak_above = F.pad(peak[..., 1:], (0, 1))    # bin f + 1 is a peak
    advance = torch.where(peak_below, F.pad(omega[..., :-1], (1, 0)),
                          torch.where(peak_above, F.pad(omega[..., 1:], (0, 1)), omega))
    if keep is identity:
        return torch.cumsum(advance, dim=-2)
    phase = [keep(advance[..., 0, :])]
    for t in range(1, advance.shape[-2]):
        phase.append(keep(phase[-1] + keep(advance[..., t, :])))
    return torch.stack(phase, dim=-2)


def invert(mag: torch.Tensor, window: torch.Tensor, hop: int, max_iter: int, tol: float,
           eva_iter: int, alpha: float, keep=identity) -> torch.Tensor:
    """Griffin-Lim of a magnitude ``(B, F, T)`` -> waveform ``(B, (T - 1) * hop)``."""
    n = window.shape[-1]
    target = keep(mag.transpose(-1, -2))
    lr = alpha / (1 + alpha)
    pre = keep(torch.polar(target, spsi(target, n, hop, keep)))
    x = istft(pre, window, hop, keep)
    first = previous = None
    for i in range(max_iter):
        spec = stft(x, window, hop, keep)
        out = spec.abs()
        spec = keep(spec - lr * pre)
        pre = spec
        x = istft(keep(spec * (target / (spec.abs() + PROJ_EPS))), window, hop, keep)
        if i % eva_iter != eva_iter - 1 or tol <= 0:
            continue
        loss = float(torch.mean((out - target) ** 2))
        if first is None:
            first = loss
        elif (previous - loss) / first < tol and previous > loss:
            break
        previous = loss
    return x
