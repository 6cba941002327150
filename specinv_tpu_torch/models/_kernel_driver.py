"""Geometry and glue for the Griffin-Lim kernel driver.

Counterpart of ``specinv_tpu/models/_pallas_driver.py``.  The kernel path
iterates a signal held in *padded coordinates*: the center padding lives
inside the buffer, each iteration multiplies the overlap-add by
``interior_mask / envelope`` and then re-writes the two ``pad_amount``-sample
edges according to the pad mode, which is what ``torch.stft``'s centering
does on every analysis call.

The port keeps no padded frame rows: the buffer is exactly
``lp = (T-1)*hop + n_fft`` samples and the state planes are ``(B, T, F)``
onesided complex, in natural bin order.  The JAX package's time-block sizing
(``auto_block_t``, ``resolve_block_t``) sizes TPU VMEM tiles and has no
counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import STFTConfig
from ..ops import fourier
from ..ops.framing import frame, ola_envelope, overlap_add

PROJ_EPS = 1e-16


class PaddedGeometry(NamedTuple):
    lp: int     # padded signal length (T-1)*hop + n_fft
    l_out: int  # output length, lp - 2*p_amt
    p_amt: int  # center padding on each side
    e: int      # last real sample index, padded coords


def make_geometry(cfg: STFTConfig, T: int) -> PaddedGeometry:
    lp = (T - 1) * cfg.hop_length + cfg.n_fft
    p_amt = cfg.pad_amount
    l_out = lp - 2 * p_amt
    return PaddedGeometry(lp=lp, l_out=l_out, p_amt=p_amt, e=p_amt + l_out - 1)


def make_inv_env(
    cfg: STFTConfig, window: torch.Tensor, T: int, geo: PaddedGeometry
) -> torch.Tensor:
    """``interior_mask / window^2-envelope`` multiplier, length ``lp``
    (exact envelope zeros guarded to 1, as in ``istft``)."""
    env = ola_envelope(window * window, T, cfg.hop_length)
    env_safe = torch.where(env == 0, torch.ones_like(env), env)
    interior = torch.zeros(geo.lp, dtype=torch.bool, device=env.device)
    interior[geo.p_amt : geo.p_amt + geo.l_out] = True
    return torch.where(interior, 1.0 / env_safe, torch.zeros_like(env)).float()


def repad_edges(x_div: torch.Tensor, cfg: STFTConfig, geo: PaddedGeometry) -> torch.Tensor:
    """Re-apply center padding (pad regions arrive zeroed)."""
    p, e = geo.p_amt, geo.e
    if not p or cfg.pad_mode == "constant":
        return x_div
    if cfg.pad_mode == "reflect":
        left = x_div[..., p + 1 : 2 * p + 1].flip(-1)
        right = x_div[..., e - p : e].flip(-1)
    elif cfg.pad_mode == "replicate":
        left = x_div[..., p : p + 1].expand(*x_div.shape[:-1], p)
        right = x_div[..., e : e + 1].expand(*x_div.shape[:-1], p)
    else:  # circular
        left = x_div[..., e - p + 1 : e + 1]
        right = x_div[..., p : 2 * p]
    return torch.cat([left, x_div[..., p : e + 1], right], dim=-1)


def gl_twin(state, target, window, inv_env, lr, cfg: STFTConfig, geo: PaddedGeometry):
    """One Griffin-Lim iteration of the kernel's math in plain PyTorch.

    ``state = (x_pad (B, lp), pre (B, T, F) complex)``; returns
    ``((x_pad, pre), mag)`` with ``mag`` the pre-momentum ``|S|``.  This is
    the plain version of the CUDA kernel (its CPU path and its check on the
    card) and, under autograd, its backward.  The ``1e-30`` inside the square
    roots keeps the gradient finite at exact zeros; it moves no float32
    value.
    """
    x_pad, pre = state
    frames = frame(x_pad, cfg.n_fft, cfg.hop_length) * window
    s = fourier.forward(frames, cfg)
    mag = torch.sqrt(s.real * s.real + s.imag * s.imag + 1e-30)
    s = s - lr * pre
    norm = torch.sqrt(s.real * s.real + s.imag * s.imag + 1e-30) + PROJ_EPS
    fr = fourier.inverse(s * (target / norm), cfg) * window
    y = overlap_add(fr, cfg.hop_length) * inv_env
    return (repad_edges(y, cfg, geo), s), mag
