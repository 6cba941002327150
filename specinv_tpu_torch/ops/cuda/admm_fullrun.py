"""Whole-run ADMM: the CUDA kernel, its plain version, its gradient.

``csrc/admm_fullrun.cu`` replaces the TPU kernels
``specinv_tpu/ops/pallas/fullrun_lane.py::_kernel`` (``algo='admm'``) and
``admm_fused4.py::_kernel_full``, both driven as
``admm_fused4.fused_admm_run``.  :func:`fused_admm_run` keeps that driver's
contract in the port's layout: the signal ``x_pad (B, lp)`` in padded
coordinates, the Douglas-Rachford state ``Y`` and the target as ``(B, T, F)``
planes in natural bin order (``convert.state_from_jax`` carries the JAX
``Y_re``/``Y_im`` planes across).

:func:`fused_admm_iteration` is one launch of the same C entry point that
stops at the raw overlap-add, the counterpart of
``admm_fused4.fused_admm_iteration4`` (``admm_fused4.py::_kernel_iter``,
one iteration per launch, a row count that differs per shard) with
``normalize=False``, the form the sequence-parallel path calls.

On a CPU tensor both run their plain version; on a CUDA tensor they queue
kernel iterations on the current stream with no host sync, or raise.
Gradients flow through a ``torch.autograd.Function`` whose backward replays
the plain twin (``models/_kernel_driver.admm_twin``) under autograd, as the
JAX package's ``custom_vjp`` replays ``admm_xla_twin4``.
"""
from __future__ import annotations

import torch

from ...config import STFTConfig
from ...models._kernel_driver import admm_twin
from ...utils.profiling import span
from . import _fullrun
from ._fullrun import (  # noqa: F401  (supports: the kernel's config rule, read here too)
    outputs, supports, valid_count, valid_frames,
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


def _plain(x_pad, Y, target, window, inv_env, rho, cfg: STFTConfig, n_iters: int,
           emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
           valid_t: int = 0):
    """``n_iters`` plain iterations; ``valid_t`` is an explicit frame count
    (0: every frame's ``Y`` is zeroed) and an ``inv_env`` of None stops each
    at the raw overlap-add."""
    geo = _fullrun.geometry(cfg, target.shape[-2], inv_env)
    state, mag = (x_pad, Y), None
    for _ in range(n_iters):
        state, mag = admm_twin(state, target, window, inv_env, rho, cfg, geo, valid_t)
    stats = _fullrun.eval_sums(mag, target, valid_t) if with_loss else None
    return outputs(*state, mag, stats, emit_state, with_mag, with_loss)


def fused_admm_run_reference(
    x_pad, Y, target, window, inv_env, rho, cfg: STFTConfig, n_iters: int,
    emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
    valid_t: int = 0,
):
    """Plain PyTorch version of :func:`fused_admm_run` (same contract)."""
    return _plain(x_pad, Y, target, window, inv_env, rho, cfg, n_iters, emit_state,
                  with_mag, with_loss, valid_frames(valid_t, target.shape[-2]))


def fused_admm_iteration_reference(
    x_pad, Y, target, window, rho, cfg: STFTConfig, with_mag: bool = False,
    with_loss: bool = False, valid_t=None,
):
    """Plain PyTorch version of :func:`fused_admm_iteration` (same contract)."""
    return _plain(x_pad, Y, target, window, None, rho, cfg, 1, True, with_mag, with_loss,
                  valid_count(valid_t, target.shape[-2]))


def _launch(x_pad, Y, target, window, inv_env, rho, cfg, n_iters, with_mag, with_loss,
            valid, count):
    """Queue ``n_iters`` kernel iterations, calling ``count(many_wave)``
    before each; returns ``(x, Y, mag, stats)``."""
    return _fullrun.launch(
        "specinv_admm_iteration", count, x_pad, Y, target, window, inv_env, rho, cfg, n_iters,
        with_mag, with_loss, valid,
    )


class _ADMMRun(torch.autograd.Function):
    """Kernel forward; backward replays the plain twin under autograd."""

    @staticmethod
    def forward(ctx, x_pad, Y, target, window, inv_env, rho, cfg, n_iters,
                with_mag, with_loss, valid, count):
        x, y_out, mag, stats = _launch(
            x_pad, Y, target, window, inv_env, rho, cfg, n_iters, with_mag, with_loss,
            valid, count,
        )
        ctx.save_for_backward(x_pad, Y, target, window, inv_env)
        ctx.scalar, ctx.cfg, ctx.n_iters, ctx.valid_t = rho, cfg, n_iters, valid
        extras = [t for t in (mag, stats) if t is not None]
        ctx.mark_non_differentiable(*extras)
        return (x, y_out, *extras)

    @staticmethod
    def backward(ctx, g_x, g_y, *_g_extras):
        grads = _fullrun.replay_backward(ctx, _plain, g_x, g_y)
        return (*grads, None, None, None, None, None, None, None)


def fused_admm_run(
    x_pad, Y, target, window, inv_env, rho, cfg: STFTConfig, n_iters: int,
    emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
    valid_t: int = 0,
):
    """Run ``n_iters`` DR-ADMM iterations -> final ``x_pad (B, lp)``.

    The initial state is the reference's ``Y = X`` = the seeded spectrum,
    ``U = 0``.  With ``emit_state`` the final ``Y`` is returned too; with
    ``with_mag`` the pre-update ``|R|`` of the LAST iteration ``(B, T, F)``;
    with ``with_loss`` the eval sums ``[sum (|R|-tgt)^2, sum |R|^2]`` of the
    last iteration over the first ``valid_t`` frames.  ``valid_t`` (0 = all
    ``T``) also zeroes ``Y`` on the frames past it.  Return order
    ``x[, Y][, mag][, stats]``, as in the JAX driver.  One ``specinv.launch``
    span covers the dispatch.
    """
    with span("launch"):
        if x_pad.device.type == "cpu":
            return fused_admm_run_reference(
                x_pad, Y, target, window, inv_env, rho, cfg, n_iters,
                emit_state, with_mag, with_loss, valid_t,
            )
        _fullrun.check_config(cfg, window, n_iters, "ADMM")
        return _fullrun.apply(_ADMMRun, x_pad, Y, target, window, inv_env, rho, cfg, n_iters,
                              emit_state, with_mag, with_loss,
                              valid_frames(valid_t, target.shape[-2]), _count)


def fused_admm_iteration(
    x_pad, Y, target, window, rho, cfg: STFTConfig, with_mag: bool = False,
    with_loss: bool = False, valid_t=None,
):
    """One raw DR-ADMM iteration, one kernel launch -> ``(x, Y[, mag][,
    stats])``, the counterpart of ``admm_fused4.fused_admm_iteration4`` with
    ``normalize=False``.

    The signal is the raw overlap-add of the windowed frames, ``(B,
    (T-1)*hop + n_fft)``, with no envelope and no re-pad: times the envelope
    and re-padded it is one iteration of :func:`fused_admm_run`.
    ``valid_t`` counts the frames that keep their ``Y`` and enter the eval
    sums: None for all ``T``, 0 for none (a shard of padding rows; the
    whole-run dispatch reads 0 as all).
    """
    if x_pad.device.type == "cpu":
        return fused_admm_iteration_reference(
            x_pad, Y, target, window, rho, cfg, with_mag, with_loss, valid_t,
        )
    _fullrun.check_config(cfg, window, 1, "ADMM")
    return _fullrun.apply(_ADMMRun, x_pad, Y, target, window, None, rho, cfg, 1, True,
                          with_mag, with_loss, valid_count(valid_t, target.shape[-2]),
                          _count_iteration)
