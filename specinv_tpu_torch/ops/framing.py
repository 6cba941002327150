"""Framing and overlap-add on torch tensors.

Counterpart of ``specinv_tpu/ops/framing.py``.  Framing is a strided view
(``Tensor.unfold``); overlap-add keeps the JAX package's dense formulation:
when ``n_fft = k * hop`` every frame is ``k`` hop-sized chunks, and chunk
``j`` of frame ``t`` lands at offset ``(t + j) * hop``, so the sum is ``k``
shifted contiguous adds (no scatter, deterministic, differentiable).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import STFTConfig


def pad_center(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Apply torch.stft-style center padding along the last axis."""
    if not cfg.center:
        return x
    p = cfg.pad_amount
    if cfg.pad_mode == "constant":
        return F.pad(x, (p, p))
    # F.pad's non-constant modes take (C, W) / (N, C, W): fold the leading dims
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return F.pad(flat, (p, p), mode=cfg.torch_pad_mode).reshape(*lead, -1)


def frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Slice ``x`` (..., L) into overlapping frames (..., T, frame_length)."""
    length = x.shape[-1]
    if length < frame_length:
        raise ValueError(
            f"signal length {length} shorter than frame length {frame_length}"
        )
    return x.unfold(-1, frame_length, hop_length)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add frames (..., T, N) into a signal (..., (T-1)*hop + N)."""
    *batch, num_frames, frame_length = frames.shape
    k = math.ceil(frame_length / hop_length)
    padded_frame = k * hop_length
    if padded_frame != frame_length:
        frames = F.pad(frames, (0, padded_frame - frame_length))
    chunks = frames.reshape(*batch, num_frames, k, hop_length)
    out_len = (num_frames - 1) * hop_length + padded_frame
    run = num_frames * hop_length
    total = None
    for j in range(k):
        flat = chunks[..., :, j, :].reshape(*batch, run)
        shifted = F.pad(flat, (j * hop_length, out_len - run - j * hop_length))
        total = shifted if total is None else total + shifted
    true_len = (num_frames - 1) * hop_length + frame_length
    return total[..., :true_len]


def ola_envelope(
    window_sq: torch.Tensor, num_frames: int, hop_length: int
) -> torch.Tensor:
    """Window-squared OLA normalization envelope, shape ((T-1)*hop + n_fft,)."""
    tiled = window_sq.expand(num_frames, window_sq.shape[-1])
    return overlap_add(tiled, hop_length)
