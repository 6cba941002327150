"""The kernels' plain twins, their geometry, and the replay of a twin under
autograd.

Counterpart of the plain parts of ``specinv_tpu/models/_pallas_driver.py``.
A twin is a hand-written kernel's math in plain PyTorch: the kernel's CPU
path, its check on the card and, under autograd (:func:`replay`), its
backward.

The kernel paths (the whole-run kernels and the direct-DFT kernels of
``backend='dft'``) iterate a signal held in *padded coordinates*: the center
padding lives inside the buffer, each iteration multiplies the overlap-add
by ``interior_mask / envelope`` and then re-writes the two
``pad_amount``-sample edges according to the pad mode, which is what
``torch.stft``'s centering does on every analysis call.

The port keeps no padded frame rows: the buffer is exactly
``lp = (T-1)*hop + n_fft`` samples and the state planes are ``(B, T, F)``
onesided complex, in natural bin order.  The JAX package's time-block sizing
(``auto_block_t``, ``resolve_block_t``) sizes TPU VMEM tiles and has no
counterpart.

The RTISI-LA twins (:func:`rtisi_twin`, :func:`rtisi_steps_twin`) keep the
plain path's state layout, the JAX XLA path's ``RTISIState``: committed
frames ``(B, num_keep, n_fft)``, in-flight frames ``(B, la+1, n_fft)`` and
momentum ``(B, la+1, F)`` complex, onesided in natural bin order.  The
kernel takes the same layout, so neither the JAX kernel's permuted momentum
planes nor its streamer's second state layout have a counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import STFTConfig
from . import dft, fourier
from .framing import frame, ola_envelope, overlap_add

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


def raw_geometry(cfg: STFTConfig, T: int) -> PaddedGeometry:
    """The geometry of an iteration that stops at the raw overlap-add (the
    JAX ``normalize=False``): no edge pads, every one of the ``lp`` samples
    is real, so :func:`repad_edges` leaves the signal as it is."""
    lp = (T - 1) * cfg.hop_length + cfg.n_fft
    return PaddedGeometry(lp=lp, l_out=lp, p_amt=0, e=lp - 1)


def make_inv_env(
    cfg: STFTConfig, window: torch.Tensor, T: int, geo: PaddedGeometry
) -> torch.Tensor:
    """``interior_mask / window^2-envelope`` multiplier, length ``lp``, in
    the window's type (exact envelope zeros guarded to 1, as in ``istft``)."""
    env = ola_envelope(window * window, T, cfg.hop_length)
    env_safe = torch.where(env == 0, torch.ones_like(env), env)
    interior = torch.zeros(geo.lp, dtype=torch.bool, device=env.device)
    interior[geo.p_amt : geo.p_amt + geo.l_out] = True
    return torch.where(interior, 1.0 / env_safe, torch.zeros_like(env))


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


def _normalize(y, inv_env, cfg: STFTConfig, geo: PaddedGeometry):
    """``y * inv_env`` re-padded, or the raw ``y`` when ``inv_env`` is None."""
    return y if inv_env is None else repad_edges(y * inv_env, cfg, geo)


def gl_twin(state, target, window, inv_env, lr, cfg: STFTConfig, geo: PaddedGeometry):
    """One Griffin-Lim iteration of the kernel's math in plain PyTorch.

    ``state = (x_pad (B, lp), pre (B, T, F) complex)``; returns
    ``((x_pad, pre), mag)`` with ``mag`` the pre-momentum ``|S|``.  This is
    the plain version of the CUDA kernel (its CPU path and its check on the
    card) and, under autograd, its backward.  The ``1e-30`` inside the square
    roots keeps the gradient finite at exact zeros; it moves no float32
    value.  With ``inv_env`` None and :func:`raw_geometry` it stops at the
    raw overlap-add.
    """
    x_pad, pre = state
    frames = frame(x_pad, cfg.n_fft, cfg.hop_length) * window
    s = fourier.forward(frames, cfg)
    mag = torch.sqrt(s.real * s.real + s.imag * s.imag + 1e-30)
    s = s - lr * pre
    norm = torch.sqrt(s.real * s.real + s.imag * s.imag + 1e-30) + PROJ_EPS
    fr = fourier.inverse(s * (target / norm), cfg) * window
    return (_normalize(overlap_add(fr, cfg.hop_length), inv_env, cfg, geo), s), mag


def admm_twin(state, target, window, inv_env, rho, cfg: STFTConfig, geo: PaddedGeometry,
              valid_t: int):
    """One DR-ADMM iteration of the kernel's math in plain PyTorch, the
    counterpart of the JAX ``admm_xla_twin4``.

    ``state = (x_pad (B, lp), Y (B, T, F) complex)``, the Douglas-Rachford
    one-variable form of the reference's ``(X, Y, U)`` chain (only ``Y =
    X + U`` persists); returns ``((x_pad, Y'), mag)`` with ``mag`` the
    pre-update ``|R|``.  Frames ``t >= valid_t`` get ``Y' = 0``.  Like
    :func:`gl_twin` it is the kernel's CPU path, its check on the card and
    its backward; ``inv_env`` None stops it at the raw overlap-add.
    """
    x_pad, Y = state
    frames = frame(x_pad, cfg.n_fft, cfg.hop_length) * window
    r = fourier.forward(frames, cfg)
    mag = torch.sqrt(r.real * r.real + r.imag * r.imag + 1e-30)
    z = (rho * Y + r) / (1.0 + rho)  # true division, as the JAX kernels do
    u = Y - z
    t = z - u
    norm = torch.sqrt(t.real * t.real + t.imag * t.imag + 1e-30) + PROJ_EPS
    y_new = t * (target / norm) + u
    if valid_t < y_new.shape[-2]:
        valid = torch.arange(y_new.shape[-2], device=y_new.device) < valid_t
        y_new = torch.where(valid[:, None], y_new, torch.zeros_like(y_new))
    fr = fourier.inverse(y_new, cfg) * window
    return (_normalize(overlap_add(fr, cfg.hop_length), inv_env, cfg, geo), y_new), mag


def _dft_forward(frames, tables, scheme):
    """``(re, im)`` of the direct DFT of windowed frames (``gl_fused``'s
    ``frames @ C`` and ``-(frames @ Sn)``)."""
    cos, sin, _ = tables
    return dft.scheme_matmul(frames, cos, scheme), -dft.scheme_matmul(frames, sin, scheme)


def _dft_inverse(p_re, p_im, tables, scheme):
    """``P_re @ C^T - P_im @ Sn^T``: real frames from a spectrum whose fold
    weights are already folded in."""
    cos, sin, _ = tables
    return dft.scheme_matmul(p_re, cos.T, scheme) - dft.scheme_matmul(p_im, sin.T, scheme)


def gl_dft_twin(state, target, window, inv_env, lr, cfg: STFTConfig, geo: PaddedGeometry,
                precision="high"):
    """One Griffin-Lim iteration of the direct-DFT kernel's math in plain
    PyTorch, the counterpart of the JAX ``gl_xla_twin``.

    ``state = (x_pad (B, lp), pre (B, T, F) complex)``; returns ``((x_pad,
    pre), mag)`` with ``mag`` the pre-momentum ``|S|``.  ``precision`` is a
    scheme of ``ops/dft.py`` or a ``(forward, inverse)`` pair.  This is the
    plain version of ``csrc/gl_fused.cu`` (its CPU path and its check on
    the card) and, at ``'highest'``, its backward.  It computes in
    ``x_pad``'s type.
    """
    x_pad, pre = state
    fwd, inv = dft.split_schemes(precision)
    tables = dft.table_tensors(cfg.n_fft, cfg.normalized, x_pad.device, x_pad.dtype)
    frames = frame(x_pad, cfg.n_fft, cfg.hop_length) * window
    s_re, s_im = _dft_forward(frames, tables, fwd)
    mag = torch.sqrt(s_re * s_re + s_im * s_im + 1e-30)
    s_re = s_re - lr * pre.real
    s_im = s_im - lr * pre.imag
    norm = torch.sqrt(s_re * s_re + s_im * s_im + 1e-30) + PROJ_EPS
    gain = target / norm * tables[2]
    fr = _dft_inverse(s_re * gain, s_im * gain, tables, inv) * window
    y = overlap_add(fr, cfg.hop_length) * inv_env
    return (repad_edges(y, cfg, geo), torch.complex(s_re, s_im)), mag


def admm_dft_twin(state, target, window, inv_env, rho, cfg: STFTConfig, geo: PaddedGeometry,
                  valid_t: int, precision="high"):
    """One DR-ADMM iteration of the direct-DFT kernel's math in plain
    PyTorch, the counterpart of the JAX ``admm_xla_twin``.

    ``state = (x_pad (B, lp), Y (B, T, F) complex)``; returns ``((x_pad,
    Y'), mag)`` with ``mag`` the pre-update ``|R|``; frames ``t >= valid_t``
    get ``Y' = 0``, and the inverse transforms ``Y' * w``.  ``precision`` is
    one scheme.  Like :func:`gl_dft_twin` it is the kernel's CPU path, its
    check on the card and, at ``'highest'``, its backward.
    """
    x_pad, Y = state
    tables = dft.table_tensors(cfg.n_fft, cfg.normalized, x_pad.device, x_pad.dtype)
    frames = frame(x_pad, cfg.n_fft, cfg.hop_length) * window
    r_re, r_im = _dft_forward(frames, tables, precision)
    mag = torch.sqrt(r_re * r_re + r_im * r_im + 1e-30)
    onep = 1.0 + rho  # true division, as the JAX kernels do
    z_re = (rho * Y.real + r_re) / onep
    z_im = (rho * Y.imag + r_im) / onep
    u_re, u_im = Y.real - z_re, Y.imag - z_im
    t_re, t_im = z_re - u_re, z_im - u_im
    norm = torch.sqrt(t_re * t_re + t_im * t_im + 1e-30) + PROJ_EPS
    gain = target / norm
    yn_re, yn_im = t_re * gain + u_re, t_im * gain + u_im
    if valid_t < yn_re.shape[-2]:
        valid = (torch.arange(yn_re.shape[-2], device=yn_re.device) < valid_t)[:, None]
        yn_re = torch.where(valid, yn_re, torch.zeros_like(yn_re))
        yn_im = torch.where(valid, yn_im, torch.zeros_like(yn_im))
    w = tables[2]
    fr = _dft_inverse(yn_re * w, yn_im * w, tables, precision) * window
    y = overlap_add(fr, cfg.hop_length) * inv_env
    return (repad_edges(y, cfg, geo), torch.complex(yn_re, yn_im)), mag


class RTISIWindows(NamedTuple):
    window: torch.Tensor  # analysis window of every in-flight frame but the newest
    first: torch.Tensor   # the newest frame's analysis window on refinement 0
    rest: torch.Tensor    # the newest frame's analysis window on later refinements
    synth: torch.Tensor   # window * hop / sum(window^2): the OLA synthesis window


def rtisi_tail(keeped: torch.Tensor, synth: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """The committed frames' synthesis OLA with the committed prefix dropped,
    zero-padded to ``length`` samples: ``(B, length)``."""
    B, num_keep, _ = keeped.shape
    if num_keep == 0:
        return keeped.new_zeros((B, length))
    tail = overlap_add(keeped * synth, hop)[..., num_keep * hop :]
    return F.pad(tail, (0, length - tail.shape[-1]))


def rtisi_twin(x_keep, update, pre, target, windows: RTISIWindows, lr, cfg: STFTConfig,
               max_iter: int):
    """All ``max_iter`` refinements of one RTISI-LA step in plain PyTorch,
    the counterpart of the JAX ``rtisi_xla_twin4``.

    ``x_keep (B, L)`` is the committed tail (:func:`rtisi_tail`), ``update
    (B, R, n_fft)``, ``pre (B, R, F)`` complex and ``target (B, R, F)``,
    ``R = la + 1``; returns ``(update, pre)``.  Refinement 0 takes the next
    frame's momentum (the newest frame none) and the newest frame's
    ``windows.first``; later ones ``windows.rest``.
    """
    n, hop = cfg.n_fft, cfg.hop_length
    R = update.shape[-2]
    for j in range(max_iter):
        xs = x_keep + overlap_add(update * windows.synth, hop)
        last = windows.first if j == 0 else windows.rest
        rows = torch.cat([windows.window.expand(R - 1, n), last[None]], dim=0)
        s = fourier.forward(frame(xs, n, hop) * rows, cfg)
        if j == 0:
            pre = torch.cat([pre[:, 1:], torch.zeros_like(pre[:, :1])], dim=1)
        s = s - lr * pre
        pre = s
        update = fourier.inverse(s * (target / (s.abs() + PROJ_EPS)), cfg)
    return update, pre


def rtisi_steps_twin(keeped, update, pre, target, windows: RTISIWindows, lr,
                     cfg: STFTConfig, max_iter: int):
    """``k`` chained RTISI-LA steps in plain PyTorch, the counterpart of the
    JAX ``rtisi_la._multi_twin``: per step the committed tail, the
    refinements (:func:`rtisi_twin`), then commit and slide.

    ``target (B, k + la, F)`` is the window of magnitude frames: step ``s``
    refines against rows ``s .. s + la``.  Returns ``(committed (k, B,
    n_fft), keeped, update, pre)``.  This is the plain version of the CUDA
    kernel (its CPU path and its check on the card) and, under autograd,
    its backward.
    """
    R = update.shape[-2]
    length = (R - 1) * cfg.hop_length + cfg.n_fft
    committed = []
    for step in range(target.shape[-2] - R + 1):
        x_keep = rtisi_tail(keeped, windows.synth, cfg.hop_length, length)
        update, pre = rtisi_twin(x_keep, update, pre, target[:, step : step + R], windows,
                                 lr, cfg, max_iter)
        committed.append(update[:, 0])
        if keeped.shape[1]:
            keeped = torch.cat([keeped[:, 1:], update[:, :1]], dim=1)
        update = torch.cat([update[:, 1:], torch.zeros_like(update[:, :1])], dim=1)
    return torch.stack(committed), keeped, update, pre


def replay(twin, saved, needs, grads_out):
    """The backward of a kernel's ``autograd.Function``: pull ``grads_out``
    back through ``twin`` (its plain version: the saved inputs -> the
    differentiable outputs) replayed under autograd from ``saved`` (entries
    may be None), where ``needs`` asks -> a gradient or None per input.  An
    output that depends on no input that needs a gradient has none."""
    inputs = [t if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
    wrt = [t for t in inputs if t is not None and t.requires_grad]
    with torch.enable_grad():
        outs = twin(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if o.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                         allow_unused=True) if pairs else [None] * len(wrt))
    return [next(grads) if t is not None and t.requires_grad else None for t in inputs]
