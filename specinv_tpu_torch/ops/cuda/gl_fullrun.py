"""Whole-run Griffin-Lim: the CUDA kernel, its plain version, its gradient.

``csrc/gl_fullrun.cu`` replaces the TPU kernel
``specinv_tpu/ops/pallas/fullrun_lane.py::_kernel`` (``algo='gl'``), driven
as ``gl_fullrun4.fused_gl_run``.  :func:`fused_gl_run` keeps that driver's
contract in the port's layout: the signal ``x_pad (B, lp)`` in padded
coordinates, the momentum ``pre`` and the target as ``(B, T, F)`` onesided
planes in natural bin order.

On a CPU tensor it runs :func:`fused_gl_run_reference`; on a CUDA tensor it
queues ``n_iters`` kernel iterations on the current stream with no host
sync, or raises.  Gradients flow through a ``torch.autograd.Function`` whose
backward replays the plain twin (``models/_kernel_driver.gl_twin``) under
autograd, as the JAX package's ``custom_vjp`` replays ``gl_xla_twin4``.
"""
from __future__ import annotations

import torch

from ...config import STFTConfig
from ...models._kernel_driver import gl_twin, make_geometry
from . import _build
from .fft import scales, supported_size, twiddles

_PAD_CODES = {"constant": 0, "reflect": 1, "replicate": 2, "circular": 3}

# Kernel iterations launched (one gl_frame + one gl_ola launch each).
launches = 0


def supports(cfg: STFTConfig, window) -> bool:
    """Whether the kernel takes this config: n_fft a power of two in
    [16, 4096], 0 < hop <= n_fft, and a real window."""
    return (
        supported_size(cfg.n_fft)
        and 0 < cfg.hop_length <= cfg.n_fft
        and not torch.as_tensor(window).is_complex()
    )


def _outputs(x, pre, mag, stats, emit_state, with_mag, with_loss):
    if not (emit_state or with_mag or with_loss):
        return x
    out = [x]
    if emit_state:
        out.append(pre)
    if with_mag:
        out.append(mag)
    if with_loss:
        out.append(stats)
    return tuple(out)


def _valid_frames(valid_t: int, T: int) -> int:
    if not 0 <= valid_t <= T:
        raise ValueError(f"valid_t={valid_t} must lie in [0, T={T}]")
    return valid_t or T


def fused_gl_run_reference(
    x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig, n_iters: int,
    emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
    valid_t: int = 0,
):
    """Plain PyTorch version of :func:`fused_gl_run` (same contract)."""
    T = target.shape[-2]
    geo = make_geometry(cfg, T)
    state, mag = (x_pad, pre), None
    for _ in range(n_iters):
        state, mag = gl_twin(state, target, window, inv_env, lr, cfg, geo)
    stats = None
    if with_loss:
        v = _valid_frames(valid_t, T)
        m, tg = mag[:, :v], target[:, :v]
        stats = torch.stack([torch.sum((m - tg) ** 2), torch.sum(m * m)])
    return _outputs(*state, mag, stats, emit_state, with_mag, with_loss)


def _launch(x_pad, pre, target, window, inv_env, lr, cfg, n_iters, with_mag,
            with_loss, valid_t):
    """Queue ``n_iters`` kernel iterations; returns (x, pre, mag, stats)."""
    global launches
    B, T, n_bins = target.shape
    n, hop = cfg.n_fft, cfg.hop_length
    geo = make_geometry(cfg, T)
    dev = x_pad.device
    if n_bins != cfg.num_freqs:
        raise ValueError(f"target has {n_bins} bins, the config {cfg.num_freqs}")
    for name, t, dtype, shape in (
        ("x_pad", x_pad, torch.float32, (B, geo.lp)),
        ("pre", pre, torch.complex64, (B, T, n_bins)),
        ("target", target, torch.float32, (B, T, n_bins)),
        ("window", window, torch.float32, (n,)),
        ("inv_env", inv_env, torch.float32, (geo.lp,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    target, window, inv_env = (t.contiguous() for t in (target, window, inv_env))
    x_a = x_pad.contiguous().clone()
    x_b = torch.empty_like(x_a)
    pre = pre.contiguous().clone()  # updated in place by the kernel
    frames = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    mag = torch.empty((B, T, n_bins), dtype=torch.float32, device=dev) if with_mag else None
    partial = torch.zeros((B, T, 2), dtype=torch.float32, device=dev) if with_loss else None
    fscale, iscale = scales(n, cfg.normalized)
    tw = twiddles(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    for it in range(n_iters):
        last = it == n_iters - 1
        launches += 1
        code = lib.specinv_gl_iteration(
            x_a.data_ptr(), x_b.data_ptr(), pre.data_ptr(), target.data_ptr(),
            window.data_ptr(), tw.data_ptr(), inv_env.data_ptr(), frames.data_ptr(),
            mag.data_ptr() if (with_mag and last) else None,
            partial.data_ptr() if (with_loss and last) else None,
            B, T, n, n.bit_length() - 1, hop, n_bins, geo.lp, int(cfg.onesided),
            geo.p_amt, geo.e, _PAD_CODES[cfg.pad_mode],
            float(lr), fscale, iscale, _valid_frames(valid_t, T), stream,
        )
        _build.check(code, "specinv_gl_iteration")
        x_a, x_b = x_b, x_a
    stats = partial.sum(dim=(0, 1)) if with_loss else None
    return x_a, pre, mag, stats


class _GLRun(torch.autograd.Function):
    """Kernel forward; backward replays the plain twin under autograd."""

    @staticmethod
    def forward(ctx, x_pad, pre, target, window, inv_env, lr, cfg, n_iters,
                with_mag, with_loss, valid_t):
        x, pre_out, mag, stats = _launch(
            x_pad, pre, target, window, inv_env, lr, cfg, n_iters, with_mag,
            with_loss, valid_t,
        )
        ctx.save_for_backward(x_pad, pre, target, window, inv_env)
        ctx.lr, ctx.cfg, ctx.n_iters = lr, cfg, n_iters
        extras = [t for t in (mag, stats) if t is not None]
        ctx.mark_non_differentiable(*extras)
        return (x, pre_out, *extras)

    @staticmethod
    def backward(ctx, g_x, g_pre, *_g_extras):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            x, pre = fused_gl_run_reference(
                *inputs, ctx.lr, ctx.cfg, ctx.n_iters, emit_state=True,
            )
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad((x, pre), wrt, (g_x, g_pre), allow_unused=True))
        return (*[next(grads) if t.requires_grad else None for t in inputs],
                None, None, None, None, None, None)


def fused_gl_run(
    x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig, n_iters: int,
    emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
    valid_t: int = 0,
):
    """Run ``n_iters`` Griffin-Lim iterations -> final ``x_pad (B, lp)``.

    With ``emit_state`` the final momentum ``pre`` is returned too; with
    ``with_mag`` the pre-momentum ``|S|`` of the LAST iteration ``(B, T, F)``;
    with ``with_loss`` the eval sums ``[sum (|S|-tgt)^2, sum |S|^2]`` of the
    last iteration over the first ``valid_t`` frames (0 = all).  Return order
    ``x[, pre][, mag][, stats]``, as in the JAX driver.
    """
    if x_pad.device.type == "cpu":
        return fused_gl_run_reference(
            x_pad, pre, target, window, inv_env, lr, cfg, n_iters,
            emit_state, with_mag, with_loss, valid_t,
        )
    if not supports(cfg, window):
        raise ValueError(
            f"the Griffin-Lim kernel needs n_fft a power of two in [16, 4096], "
            f"0 < hop <= n_fft and a real window (n_fft={cfg.n_fft}, "
            f"hop={cfg.hop_length})"
        )
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    x, pre_out, *extras = _GLRun.apply(
        x_pad, pre, target, window, inv_env, float(lr), cfg, n_iters, with_mag,
        with_loss, valid_t,
    )
    mag = extras.pop(0) if with_mag else None
    stats = extras.pop(0) if with_loss else None
    return _outputs(x, pre_out, mag, stats, emit_state, with_mag, with_loss)
