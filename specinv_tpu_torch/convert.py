"""Carry state across from the JAX package's kernel layout (numpy only).

The system has no model weights: what one implementation hands the other is
the STFT configuration, the window and the iteration state.  The JAX
whole-run kernels keep their planes in the four-step permuted full-spectrum
layout ``(B, t_pad, m, 128)`` with ``out[..., d, e] = full[..., d + m*e]``
(``fft4.to_permuted``) and frame rows padded to ``t_pad``; the port keeps
``(B, T, F)`` onesided planes in natural bin order and a signal of exactly
``lp = (T-1)*hop + n_fft`` samples.  The JAX direct-DFT kernels keep natural
bin order with padded rows and lanes (:func:`dft_state_from_jax`).
"""
from __future__ import annotations

import numpy as np

from .config import STFTConfig


def config_from_fields(n_fft, hop_length, center, pad_mode, normalized, onesided) -> STFTConfig:
    """An :class:`STFTConfig` from the fields of the JAX package's config."""
    return STFTConfig(
        n_fft=int(n_fft), hop_length=int(hop_length), center=bool(center),
        pad_mode=str(pad_mode), normalized=bool(normalized), onesided=bool(onesided),
    )


def from_permuted(perm: np.ndarray, n_fft: int) -> np.ndarray:
    """Invert ``fft4.to_permuted``: (..., m, 128) -> (..., n_fft)."""
    perm = np.asarray(perm)
    return np.swapaxes(perm, -1, -2).reshape(*perm.shape[:-2], n_fft)


def state_from_jax(x_pad, pre_re_perm, pre_im_perm, target_perm, n_fft: int, T: int,
                   onesided: bool = True):
    """JAX kernel state -> ``(x_pad, pre, target)`` in the port's layout.

    ``x_pad`` (B, lx), ``lx = (t_pad-1)*hop + n_fft``, is trimmed to ``lp``
    samples (the JAX tail past ``lp`` holds only padded frames); the
    permuted planes lose their ``t_pad - T`` padded rows and become
    ``(B, T, F)`` with ``F = n_fft//2 + 1`` (onesided) or ``n_fft``; ``pre``
    is complex.  Any state pair converts the same way: the Griffin-Lim
    momentum planes and the ADMM ``Y_re``/``Y_im`` planes alike.
    """
    n_bins = n_fft // 2 + 1 if onesided else n_fft

    def plane(p):
        return from_permuted(p, n_fft)[:, :T, :n_bins]

    pre = plane(pre_re_perm) + 1j * plane(pre_im_perm)
    x = np.asarray(x_pad)
    t_pad = np.shape(target_perm)[1]
    if t_pad > 1:
        hop = (x.shape[-1] - n_fft) // (t_pad - 1)
        x = x[..., : (T - 1) * hop + n_fft]
    return x, pre.astype(np.complex64), plane(target_perm)


def dft_state_from_jax(x_pad, re, im, target, n_fft: int, T: int):
    """The JAX direct-DFT kernels' state -> ``(x_pad, plane, target)`` in
    the port's layout.

    The JAX ``pallas`` path (``gl_fused`` / ``admm_fused``) keeps ``x_pad
    (B, lx)``, ``lx = (t_pad-1)*hop + n_fft``, and ``re``, ``im`` and
    ``target`` as ``(B, t_pad, f_pad)`` planes in natural bin order with
    ``t_pad - T`` padded rows and ``f_pad - F`` padded lanes.  The signal is
    trimmed to ``lp`` samples, the planes to ``(B, T, F)``, ``F = n_fft//2 +
    1``, and ``re``/``im`` (the Griffin-Lim momentum or the ADMM ``Y``)
    become one complex64 plane.
    """
    n_bins = n_fft // 2 + 1
    x = np.asarray(x_pad)
    t_pad = np.shape(target)[1]
    if t_pad > 1:
        hop = (x.shape[-1] - n_fft) // (t_pad - 1)
        x = x[..., : (T - 1) * hop + n_fft]

    def plane(p):
        return np.asarray(p)[:, :T, :n_bins]

    return x, (plane(re) + 1j * plane(im)).astype(np.complex64), plane(target)


def rtisi_state_from_jax(state):
    """A JAX ``RTISIState`` -> ``(keeped, update, pre_spec)`` in the port's
    layout (numpy arrays).

    The XLA path's state carries over as it is (``pre_spec (B, la+1, F)``
    complex).  The kernel-mode streamer's state carries the momentum as a
    pair of batch-major permuted planes ``(B, la+1, m, 128)``; they become
    the onesided complex spectrum in natural bin order, and the mirror bins
    above ``n_fft // 2`` are dropped.
    """
    keeped, update, pre = state
    keeped, update = np.asarray(keeped), np.asarray(update)
    if isinstance(pre, tuple):
        n_fft = update.shape[-1]
        re, im = (from_permuted(p, n_fft)[..., : n_fft // 2 + 1] for p in pre)
        pre = (re + 1j * im).astype(np.complex64)
    return keeped, update, np.asarray(pre)
