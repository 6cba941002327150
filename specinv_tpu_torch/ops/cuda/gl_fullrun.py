"""Whole-run Griffin-Lim: the CUDA kernel, its plain version, its gradient.

``csrc/gl_fullrun.cu`` replaces the TPU kernels
``specinv_tpu/ops/pallas/fullrun_lane.py::_kernel`` (``algo='gl'``) and
``gl_fullrun4.py::_kernel`` (the (m, 128) layout, taken when hop does not
divide n_fft), both driven as ``gl_fullrun4.fused_gl_run``.
:func:`fused_gl_run` keeps that driver's contract in the port's layout: the
signal ``x_pad (B, lp)`` in padded coordinates, the momentum ``pre`` and the
target as ``(B, T, F)`` onesided planes in natural bin order.

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
from . import _fullrun
from ._fullrun import UNSUPPORTED, outputs, supports

# Kernel iterations launched (one frame + one OLA launch each).
launches = 0


def _count():
    global launches
    launches += 1


def fused_gl_run_reference(
    x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig, n_iters: int,
    emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
    valid_t: int = 0,
):
    """Plain PyTorch version of :func:`fused_gl_run` (same contract)."""
    geo = make_geometry(cfg, target.shape[-2])
    state, mag = (x_pad, pre), None
    for _ in range(n_iters):
        state, mag = gl_twin(state, target, window, inv_env, lr, cfg, geo)
    stats = _fullrun.eval_sums(mag, target, valid_t) if with_loss else None
    return outputs(*state, mag, stats, emit_state, with_mag, with_loss)


def _launch(x_pad, pre, target, window, inv_env, lr, cfg, n_iters, with_mag,
            with_loss, valid_t):
    """Queue ``n_iters`` kernel iterations; returns (x, pre, mag, stats)."""
    return _fullrun.launch(
        "specinv_gl_iteration", _count, x_pad, pre, target, window, inv_env, lr,
        cfg, n_iters, with_mag, with_loss, valid_t,
    )


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
        ctx.scalar, ctx.cfg, ctx.n_iters, ctx.valid_t = lr, cfg, n_iters, valid_t
        extras = [t for t in (mag, stats) if t is not None]
        ctx.mark_non_differentiable(*extras)
        return (x, pre_out, *extras)

    @staticmethod
    def backward(ctx, g_x, g_pre, *_g_extras):
        grads = _fullrun.replay_backward(ctx, fused_gl_run_reference, g_x, g_pre)
        return (*grads, None, None, None, None, None, None)


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
            f"the Griffin-Lim kernel needs {UNSUPPORTED} (n_fft={cfg.n_fft}, "
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
    return outputs(x, pre_out, mag, stats, emit_state, with_mag, with_loss)
