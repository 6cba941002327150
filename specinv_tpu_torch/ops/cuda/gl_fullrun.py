"""Whole-run Griffin-Lim: the CUDA kernel, its plain version, its gradient.

``csrc/gl_fullrun.cu`` replaces the TPU kernels
``specinv_tpu/ops/pallas/fullrun_lane.py::_kernel`` (``algo='gl'``) and
``gl_fullrun4.py::_kernel`` (the (m, 128) layout, taken when hop does not
divide n_fft), both driven as ``gl_fullrun4.fused_gl_run``.
:func:`fused_gl_run` keeps that driver's contract in the port's layout: the
signal ``x_pad (B, lp)`` in padded coordinates, the momentum ``pre`` and the
target as ``(B, T, F)`` onesided planes in natural bin order.

:func:`fused_gl_iteration` is one launch of the same C entry point that
stops at the raw overlap-add (no envelope, no re-pad), the counterpart of
``gl_fused4.fused_gl_iteration4`` (``gl_fused4.py::_kernel``, one iteration
per launch) with ``normalize=False``, the form the sequence-parallel path
calls.

On a CPU tensor both run their plain version; on a CUDA tensor they queue
kernel iterations on the current stream with no host sync, or raise.
Gradients flow through a ``torch.autograd.Function`` whose backward replays
the plain twin (``models/_kernel_driver.gl_twin``) under autograd, as the
JAX package's ``custom_vjp`` replays ``gl_xla_twin4``.
"""
from __future__ import annotations

import torch

from ...config import STFTConfig
from ...models._kernel_driver import gl_twin
from ...utils.profiling import span
from . import _fullrun
from ._fullrun import (  # noqa: F401  (supports, UNSUPPORTED: the backend rule reads them here)
    UNSUPPORTED, outputs, supports, valid_count, valid_frames,
)

# Kernel iterations launched (one frame + one OLA launch each) by the whole
# run, and by the raw per-iteration dispatch; and of both, those whose frame
# launch took the many-wave plan (_fullrun.frame_plan).
launches = 0
iteration_launches = 0
many_wave_launches = 0


def _count(many_wave: bool):
    global launches, many_wave_launches
    launches += 1
    many_wave_launches += many_wave


def _count_iteration(many_wave: bool):
    global iteration_launches, many_wave_launches
    iteration_launches += 1
    many_wave_launches += many_wave


def _plain(x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig, n_iters: int,
           emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
           valid_t: int = 0):
    """``n_iters`` plain iterations; ``valid_t`` is an explicit frame count
    and an ``inv_env`` of None stops each at the raw overlap-add."""
    geo = _fullrun.geometry(cfg, target.shape[-2], inv_env)
    state, mag = (x_pad, pre), None
    for _ in range(n_iters):
        state, mag = gl_twin(state, target, window, inv_env, lr, cfg, geo)
    stats = _fullrun.eval_sums(mag, target, valid_t) if with_loss else None
    return outputs(*state, mag, stats, emit_state, with_mag, with_loss)


def fused_gl_run_reference(
    x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig, n_iters: int,
    emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
    valid_t: int = 0,
):
    """Plain PyTorch version of :func:`fused_gl_run` (same contract)."""
    return _plain(x_pad, pre, target, window, inv_env, lr, cfg, n_iters, emit_state,
                  with_mag, with_loss, valid_frames(valid_t, target.shape[-2]))


def fused_gl_iteration_reference(
    x_pad, pre, target, window, lr, cfg: STFTConfig, with_mag: bool = False,
    with_loss: bool = False, valid_t=None,
):
    """Plain PyTorch version of :func:`fused_gl_iteration` (same contract)."""
    return _plain(x_pad, pre, target, window, None, lr, cfg, 1, True, with_mag, with_loss,
                  valid_count(valid_t, target.shape[-2]))


def _launch(x_pad, pre, target, window, inv_env, lr, cfg, n_iters, with_mag, with_loss,
            valid, count):
    """Queue ``n_iters`` kernel iterations, calling ``count(many_wave)``
    before each; returns ``(x, pre, mag, stats)``."""
    return _fullrun.launch(
        "specinv_gl_iteration", count, x_pad, pre, target, window, inv_env, lr, cfg, n_iters,
        with_mag, with_loss, valid,
    )


class _GLRun(torch.autograd.Function):
    """Kernel forward; backward replays the plain twin under autograd."""

    @staticmethod
    def forward(ctx, x_pad, pre, target, window, inv_env, lr, cfg, n_iters,
                with_mag, with_loss, valid, count):
        x, pre_out, mag, stats = _launch(
            x_pad, pre, target, window, inv_env, lr, cfg, n_iters, with_mag, with_loss,
            valid, count,
        )
        ctx.save_for_backward(x_pad, pre, target, window, inv_env)
        ctx.scalar, ctx.cfg, ctx.n_iters, ctx.valid_t = lr, cfg, n_iters, valid
        extras = [t for t in (mag, stats) if t is not None]
        ctx.mark_non_differentiable(*extras)
        return (x, pre_out, *extras)

    @staticmethod
    def backward(ctx, g_x, g_pre, *_g_extras):
        grads = _fullrun.replay_backward(ctx, _plain, g_x, g_pre)
        return (*grads, None, None, None, None, None, None, None)


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
    ``x[, pre][, mag][, stats]``, as in the JAX driver.  One
    ``specinv.launch`` span covers the dispatch.
    """
    with span("launch"):
        if x_pad.device.type == "cpu":
            return fused_gl_run_reference(
                x_pad, pre, target, window, inv_env, lr, cfg, n_iters,
                emit_state, with_mag, with_loss, valid_t,
            )
        _fullrun.check_config(cfg, window, n_iters, "Griffin-Lim")
        return _fullrun.apply(_GLRun, x_pad, pre, target, window, inv_env, lr, cfg, n_iters,
                              emit_state, with_mag, with_loss,
                              valid_frames(valid_t, target.shape[-2]), _count)


def fused_gl_iteration(
    x_pad, pre, target, window, lr, cfg: STFTConfig, with_mag: bool = False,
    with_loss: bool = False, valid_t=None,
):
    """One raw Griffin-Lim iteration, one kernel launch -> ``(x, pre[,
    mag][, stats])``, the counterpart of ``gl_fused4.fused_gl_iteration4``
    with ``normalize=False``.

    The signal is the raw overlap-add of the windowed frames, ``(B,
    (T-1)*hop + n_fft)``, with no envelope and no re-pad: times the envelope
    and re-padded it is one iteration of :func:`fused_gl_run`.  ``valid_t``
    is the number of frames the eval sums cover: None for all ``T``, 0 for
    none.
    """
    if x_pad.device.type == "cpu":
        return fused_gl_iteration_reference(
            x_pad, pre, target, window, lr, cfg, with_mag, with_loss, valid_t,
        )
    _fullrun.check_config(cfg, window, 1, "Griffin-Lim")
    return _fullrun.apply(_GLRun, x_pad, pre, target, window, None, lr, cfg, 1, True,
                          with_mag, with_loss, valid_count(valid_t, target.shape[-2]),
                          _count_iteration)
