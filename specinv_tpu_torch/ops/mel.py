"""Mel filterbank, NNLS mel inversion and the log-mel transform.

Counterpart of ``specinv_tpu/ops/mel.py``: a Slaney-normalized (or HTK)
triangular mel filterbank built in numpy (the port's own copy), applied as
one ``(F, M)`` matmul; ``mel_to_linear``, the projected-gradient NNLS with
Nesterov momentum that inverts a power mel spectrogram, as batched
``(T, M) @ (M, F)`` matmuls; ``mel_to_audio``, NNLS followed by the port's
``griffin_lim``; and ``log_mel_transform``, a differentiable ``x -> log-mel``
function for ``L_BFGS``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import canonicalize
from ..transforms import as_tensor, numpy_dtype
from . import stft as stft_ops


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep,
        mel,
    )


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_min + f_sp * m
    )


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    n_fft: int,
    n_mels: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype: str = "float32",
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_fft//2 + 1, n_mels)."""
    if fmax is None:
        fmax = sample_rate / 2
    num_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, num_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    lower = hz_pts[:-2][None, :]   # (1, M)
    center = hz_pts[1:-1][None, :]
    upper = hz_pts[2:][None, :]
    f = fft_freqs[:, None]         # (F, 1)
    up_slope = (f - lower) / np.maximum(center - lower, 1e-10)
    down_slope = (upper - f) / np.maximum(upper - center, 1e-10)
    fb = np.maximum(0.0, np.minimum(up_slope, down_slope))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb = fb * enorm[None, :]
    return fb.astype(dtype)


def mel_to_linear(
    mel,
    n_fft: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    power: float = 2.0,
    max_iter: int = 200,
) -> torch.Tensor:
    """Invert a power mel spectrogram ``(..., M, T)`` to a linear magnitude
    spectrogram ``(..., F, T)`` by non-negative least squares.

    Solves ``min_{S >= 0} || fbᵀ S - mel ||²`` per frame with projected
    gradient descent and Nesterov momentum, from the filterbank-transpose
    backprojection scaled by its least-squares factor, for a fixed
    ``max_iter`` iterations, all frames at once.  The step is
    ``1 / (||fb||_1 ||fb||_inf)``, a bound on the Lipschitz constant.
    Returns ``S ** (1 / power)``, which ``griffin_lim`` takes directly.
    ``mel`` is a tensor on any device, or an array, which goes to the card.
    """
    mel = as_tensor(mel)
    dt = numpy_dtype(mel.dtype)
    fb_np = mel_filterbank(
        n_fft, int(mel.shape[-2]), sample_rate, fmin=fmin, fmax=fmax,
        htk=htk, norm=norm, dtype=str(dt),
    )  # (F, M)
    fb = torch.from_numpy(fb_np).to(mel.device)
    fb_t = fb.T
    m_tm = mel.transpose(-1, -2)  # (..., T, M)

    # the step from the numpy table: a host constant, no device read-back
    step = float(dt.type(1.0 / (np.linalg.norm(fb_np, 1) * np.linalg.norm(fb_np, np.inf))))

    x0 = m_tm @ fb_t  # (..., T, F)
    y0 = x0 @ fb
    num = torch.sum(y0 * m_tm, dim=-1, keepdim=True)
    den = torch.sum(y0 * y0, dim=-1, keepdim=True)
    x0 = x0 * torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.ones_like(den))
    x = z = torch.clamp(x0, min=0.0)

    # the momentum weights are the same for every frame: numpy scalars in the
    # working type, as the JAX loop carries them
    t = dt.type(1.0)
    for _ in range(max_iter):
        grad = (z @ fb - m_tm) @ fb_t
        x_new = torch.clamp(z - step * grad, min=0.0)
        t_new = dt.type(0.5) * (dt.type(1.0) + np.sqrt(dt.type(1.0) + dt.type(4.0) * t * t))
        z = x_new + float((t - dt.type(1.0)) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x.transpose(-1, -2) ** (1.0 / power)


def mel_to_audio(
    mel,
    n_fft: int,
    sample_rate: float,
    hop_length: int | None = None,
    window=None,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    power: float = 2.0,
    nnls_iter: int = 200,
    log_input: bool = False,
    log_offset: float = 1e-6,
    **griffin_lim_kwargs,
):
    """Mel spectrogram ``(..., M, T)`` -> waveform: NNLS mel inversion
    (:func:`mel_to_linear`) followed by the port's ``griffin_lim``, which
    takes every remaining kwarg (``max_iter``, ``tol``, ``backend``,
    ``precision``, ...).  ``log_input=True`` takes the
    :func:`log_mel_transform` output directly (undoes ``log(mel + eps)``).
    """
    from ..models.griffin_lim import griffin_lim

    mel = as_tensor(mel)
    if log_input:
        mel = torch.clamp(torch.exp(mel) - log_offset, min=0.0)
    lin = mel_to_linear(
        mel, n_fft, sample_rate, fmin=fmin, fmax=fmax, htk=htk, norm=norm,
        power=power, max_iter=nnls_iter,
    )
    griffin_lim_kwargs.setdefault("verbose", False)
    if window is not None:
        griffin_lim_kwargs["window"] = window
    if hop_length is not None:
        griffin_lim_kwargs["hop_length"] = hop_length
    return griffin_lim(lin, **griffin_lim_kwargs)


def log_mel_transform(
    n_fft: int,
    n_mels: int,
    sample_rate: float,
    hop_length: int | None = None,
    window=None,
    power: float = 2.0,
    log_offset: float = 1e-6,
    dtype=np.float32,
):
    """Build a differentiable ``x (..., L) -> log-mel (..., M, T)``
    transform_fn (feature axis first, the layout ``L_BFGS`` compares).

    The window and the filterbank are made in ``dtype``, as in the JAX
    package, and used in ``x``'s type on ``x``'s device (cached per device
    and type)."""
    cfg, w = canonicalize(n_fft // 2 + 1, dtype, hop_length=hop_length, window=window)
    fb = mel_filterbank(n_fft, n_mels, sample_rate, dtype=str(np.dtype(dtype)))
    tables = {}

    def on(x):
        key = (x.device, x.dtype)
        if key not in tables:
            tables[key] = (torch.from_numpy(np.ascontiguousarray(w)).to(x.device, x.dtype),
                           torch.from_numpy(fb).to(x.device, x.dtype))
        return tables[key]

    def fn(x):
        x = as_tensor(x)
        win, fbt = on(x)
        spec = stft_ops.stft(x, cfg, win).abs() ** power  # (..., T, F)
        return torch.log(spec @ fbt + log_offset).transpose(-1, -2)  # (..., M, T)

    return fn
