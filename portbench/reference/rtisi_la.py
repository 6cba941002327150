"""Plain RTISI-LA (Zhu et al. 2007), offline and as a stream: the
benchmark's reference.

The algorithm of torch_specinv's ``RTISI_LA`` with the plain analysis
window: per output frame, ``max_iter`` refinements of the ``la + 1``
in-flight frames against the committed past (synthesis window ``w * hop /
sum(w^2)``), with momentum ``alpha / (1 + alpha)`` whose first refinement
of a step takes the next frame's momentum (the newest frame none),
projection epsilon 1e-16; then the oldest in-flight frame is committed and
the buffers slide.  The newest frame starts from its zero-phase inverse.
Offline, the target is padded with ``la`` zero frames on both sides, the
first ``la`` commits are dropped and the frames are overlap-added through
the window^2 envelope; a stream emits ``hop`` samples per committed frame
through the steady-state envelope and drains its look-ahead on ``flush``.

A state is ``(keeped (B, nk, n), update (B, la + 1, n), pre (B, la + 1,
F))``, ``nk = (n - 1) // hop``.  It imports nothing of the program and
computes in the type of the tensors given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._signal import envelope, frames_of, identity, irfft, overlap_add, rfft

PROJ_EPS = 1e-16


def initial_state(first_frame: torch.Tensor, la: int, hop: int, keep=identity):
    """The state before the first step: zeros, and the zero-phase inverse
    of the first magnitude frame ``(B, F)`` as the newest in-flight frame."""
    B, n_bins = first_frame.shape
    n = 2 * (n_bins - 1)
    newest = keep(irfft(first_frame.to(torch.complex128 if first_frame.dtype == torch.float64
                                       else torch.complex64), n))
    update = torch.cat([newest.new_zeros((B, la, n)), newest[:, None]], dim=1)
    keeped = newest.new_zeros((B, (n - 1) // hop, n))
    pre = torch.zeros((B, la + 1, n_bins), dtype=torch.complex128
                      if first_frame.dtype == torch.float64 else torch.complex64,
                      device=first_frame.device)
    return keeped, update, pre


def step(state, target: torch.Tensor, window: torch.Tensor, hop: int, max_iter: int,
         alpha: float, keep=identity):
    """One output-frame step against ``target (B, la + 1, F)``; returns
    ``(state, committed (B, n))``."""
    keeped, update, pre = state
    n = window.shape[-1]
    nk = keeped.shape[1]
    lr = alpha / (1 + alpha)
    synth = window * hop / torch.sum(window * window)
    for j in range(max_iter):
        x = overlap_add(torch.cat([keeped, update], dim=1) * synth, hop)[..., nk * hop :]
        spec = keep(rfft(keep(frames_of(x, n, hop) * window)))
        if j == 0:
            spec = torch.cat([spec[:, :-1] - lr * pre[:, 1:], spec[:, -1:]], dim=1)
        else:
            spec = spec - lr * pre
        pre = keep(spec)
        update = keep(irfft(keep(pre * (target / (pre.abs() + PROJ_EPS))), n))
    committed = update[:, 0]
    keeped = torch.cat([keeped[:, 1:], update[:, :1]], dim=1) if nk else keeped
    update = torch.cat([update[:, 1:], torch.zeros_like(update[:, :1])], dim=1)
    return (keeped, update, pre), committed


def offline(mag: torch.Tensor, window: torch.Tensor, hop: int, la: int, max_iter: int,
            alpha: float, keep=identity) -> torch.Tensor:
    """RTISI-LA of a magnitude ``(B, F, T)`` -> waveform ``(B, (T - 1) * hop)``."""
    target = F.pad(mag.transpose(-1, -2), (0, 0, la, la))
    T = mag.shape[-1]
    state = initial_state(target[:, la], la, hop, keep)
    committed = []
    for i in range(T + la):
        state, frame = step(state, target[:, i : i + la + 1], window, hop, max_iter, alpha,
                            keep)
        committed.append(frame)
    return synthesize(torch.stack(committed[la:], dim=1), window, hop, keep)


def synthesize(frames: torch.Tensor, window: torch.Tensor, hop: int,
               keep=identity) -> torch.Tensor:
    """Committed frames ``(B, T, n)`` -> waveform: windowed overlap-add,
    the window^2 envelope, the centre trim."""
    n = window.shape[-1]
    y = keep(overlap_add(keep(frames * window), hop)) / envelope(window, frames.shape[1], hop)
    return keep(y[..., n // 2 : y.shape[-1] - n // 2])


def stream_envelopes(window: torch.Tensor, hop: int):
    """The steady-state envelope over one hop and the flush's decaying
    suffix envelope (zeros taken as 1)."""
    n = window.shape[-1]
    wsq = window * window
    suffix = torch.zeros_like(window)
    for j in range(-(-n // hop)):
        suffix[: n - j * hop] += wsq[j * hop :]
    steady = suffix[:hop].clone()
    steady[steady == 0] = 1
    suffix[suffix == 0] = 1
    return steady, suffix


def emit(ola: torch.Tensor, committed: torch.Tensor, window: torch.Tensor, hop: int):
    """The ``hop`` samples a committed frame completes, and the next overlap
    buffer: ``(samples (B, hop), ola (B, n))``."""
    buf = ola + committed * window
    steady, _ = stream_envelopes(window, hop)
    return buf[:, :hop] / steady, F.pad(buf[:, hop:], (0, hop))


def flush(state, ola: torch.Tensor, pending: torch.Tensor, warmup: int, window: torch.Tensor,
          hop: int, max_iter: int, alpha: float, keep=identity) -> torch.Tensor:
    """A stream's drain: the ``la`` magnitude frames still pending ``(B, la,
    F)`` stepped with zero frames after them, then the overlap buffer
    through the suffix envelope; ``warmup`` commits are still to be dropped.
    Returns the samples ``(B, n_samples)``."""
    B, m, n_bins = pending.shape
    la = state[1].shape[1] - 1
    rows = torch.cat([pending, pending.new_zeros((B, la + 1, n_bins))], dim=1)
    out = []
    for i in range(m):
        state, committed = step(state, rows[:, i : i + la + 1], window, hop, max_iter, alpha,
                                keep)
        if warmup:
            warmup -= 1
            continue
        samples, ola = emit(ola, committed, window, hop)
        out.append(keep(samples))
    _, suffix = stream_envelopes(window, hop)
    out.append(keep(ola / suffix))
    return torch.cat(out, dim=1)
