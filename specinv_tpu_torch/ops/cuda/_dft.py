"""What the direct-DFT kernels share: the config check, the device tables,
the scratch, the launch and the gradient.

``csrc/dft_iter.cuh`` is one iteration engine (a forward-product launch
with an algorithm-specific middle, an inverse-product launch and
``fullrun.cuh``'s OLA launch); ``gl_fused`` and ``admm_fused`` wrap its two
C entry points.  Both keep the signal ``x_pad (B, lp)`` in padded
coordinates and the state and target as ``(B, T, F)`` onesided planes in
natural bin order, and return ``(x_pad, mag, state)`` per iteration.
"""
from __future__ import annotations

import functools

import torch

from ...config import STFTConfig
from ...models._kernel_driver import make_geometry
from .. import dft
from . import _build
from ._fullrun import PAD_CODES

MAX_N = 4096

UNSUPPORTED = "onesided, a real window, n_fft <= 4096 and 0 < hop <= n_fft"


def supports(cfg: STFTConfig, window) -> bool:
    """Whether the direct-DFT kernels take this config: onesided, a real
    window, n_fft <= 4096 and 0 < hop <= n_fft.  No power of two and no
    multiple of 128 is needed (the TPU kernel's ``128 | n_fft`` and ``128 |
    hop`` are its tiling)."""
    return (
        cfg.onesided
        and cfg.n_fft <= MAX_N
        and 0 < cfg.hop_length <= cfg.n_fft
        and not torch.as_tensor(window).is_complex()
    )


@functools.lru_cache(maxsize=None)
def device_tables(n_fft: int, normalized: bool, device: torch.device):
    """``(cos, sin, w, cos_hi, cos_lo, sin_hi, sin_lo)`` on ``device``: the
    float32 tables of :func:`dft.dft_tables` and the bf16 halves of cos and
    sin, built once per ``(n_fft, normalized, device)`` (about 33 MB at
    n_fft 2048)."""
    cos, sin, w = dft.table_tensors(n_fft, normalized, device, torch.float32)
    (cos_hi, cos_lo), (sin_hi, sin_lo) = dft.split_bf16(cos), dft.split_bf16(sin)
    return cos, sin, w, cos_hi, cos_lo, sin_hi, sin_lo


def launch(entry: str, count, x_pad, state, target, window, inv_env, cfg: STFTConfig,
           precision, with_mag: bool, scalars):
    """One iteration of the C entry point ``entry`` on the current stream,
    calling ``count()`` first; ``scalars`` are its trailing arguments
    before the stream.  Returns ``(x, mag or None, state)``."""
    B, T, n_bins = target.shape
    n, dev = cfg.n_fft, x_pad.device
    geo = make_geometry(cfg, T)
    if n_bins != cfg.num_freqs:
        raise ValueError(f"target has {n_bins} bins, the config {cfg.num_freqs}")
    for name, t, dtype, shape in (
        ("x_pad", x_pad, torch.float32, (B, geo.lp)),
        ("state", state, torch.complex64, (B, T, n_bins)),
        ("target", target, torch.float32, (B, T, n_bins)),
        ("window", window, torch.float32, (n,)),
        ("inv_env", inv_env, torch.float32, (geo.lp,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    x_pad, state, target, window, inv_env = (
        t.contiguous() for t in (x_pad, state, target, window, inv_env))
    fwd, inv = dft.split_schemes(precision)
    tables = device_tables(n, cfg.normalized, dev)
    x_out = torch.empty_like(x_pad)
    state_out = torch.empty_like(state)
    spec = torch.empty((B, T, n_bins), dtype=torch.complex64, device=dev)
    frames = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    mag = torch.empty((B, T, n_bins), dtype=torch.float32, device=dev) if with_mag else None
    count()
    code = getattr(_build.library(), entry)(
        x_pad.data_ptr(), x_out.data_ptr(), state.data_ptr(), state_out.data_ptr(),
        target.data_ptr(), window.data_ptr(), tables[2].data_ptr(),
        *(t.data_ptr() for t in (tables[0], tables[1], *tables[3:])),
        inv_env.data_ptr(), spec.data_ptr(), frames.data_ptr(),
        mag.data_ptr() if with_mag else None,
        B, T, n, cfg.hop_length, n_bins, geo.lp, geo.p_amt, geo.e, PAD_CODES[cfg.pad_mode],
        dft.SCHEMES.index(fwd), dft.SCHEMES.index(inv), *scalars,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, entry)
    return x_out, mag, state_out


class Iteration(torch.autograd.Function):
    """One iteration: the forward from ``step`` (the kernel, or on the CPU
    the plain version), the backward from ``replay`` (the plain twin at
    ``'highest'``) under autograd, as the JAX package's ``custom_vjp``
    replays its XLA twin."""

    @staticmethod
    def forward(ctx, step, replay, x_pad, state, target, window, inv_env):
        x, mag, state_out = step(x_pad, state, target, window, inv_env)
        ctx.save_for_backward(x_pad, state, target, window, inv_env)
        ctx.replay = replay
        if mag is None:
            return x, state_out
        ctx.mark_non_differentiable(mag)
        return x, state_out, mag

    @staticmethod
    def backward(ctx, g_x, g_state, *_g_mag):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs, _mag = ctx.replay(*inputs)
            # an output that depends on no input that needs a gradient has none
            pairs = [(o, g) for o, g in zip(outs, (g_x, g_state)) if o.requires_grad]
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                             allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def iterate_once(step, replay, x_pad, state, target, window, inv_env, with_mag):
    """``(x, mag or None, state)`` of one :class:`Iteration`."""
    x, state_out, *mag = Iteration.apply(step, replay, x_pad, state, target, window, inv_env)
    return x, (mag[0] if with_mag else None), state_out
