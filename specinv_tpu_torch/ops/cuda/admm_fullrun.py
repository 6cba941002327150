"""Whole-run ADMM: the CUDA kernel, its plain version, its gradient.

``csrc/admm_fullrun.cu`` replaces the TPU kernels
``specinv_tpu/ops/pallas/fullrun_lane.py::_kernel`` (``algo='admm'``) and
``admm_fused4.py::_kernel_full``, both driven as
``admm_fused4.fused_admm_run``.  :func:`fused_admm_run` keeps that driver's
contract in the port's layout: the signal ``x_pad (B, lp)`` in padded
coordinates, the Douglas-Rachford state ``Y`` and the target as ``(B, T, F)``
planes in natural bin order (``convert.state_from_jax`` carries the JAX
``Y_re``/``Y_im`` planes across).

On a CPU tensor it runs :func:`fused_admm_run_reference`; on a CUDA tensor it
queues ``n_iters`` kernel iterations on the current stream with no host
sync, or raises.  Gradients flow through a ``torch.autograd.Function`` whose
backward replays the plain twin (``models/_kernel_driver.admm_twin``) under
autograd, as the JAX package's ``custom_vjp`` replays ``admm_xla_twin4``.
"""
from __future__ import annotations

import torch

from ...config import STFTConfig
from ...models._kernel_driver import admm_twin, make_geometry
from . import _fullrun
from ._fullrun import UNSUPPORTED, outputs, supports, valid_frames

# Kernel iterations launched (one frame + one OLA launch each).
launches = 0


def _count():
    global launches
    launches += 1


def fused_admm_run_reference(
    x_pad, Y, target, window, inv_env, rho, cfg: STFTConfig, n_iters: int,
    emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
    valid_t: int = 0,
):
    """Plain PyTorch version of :func:`fused_admm_run` (same contract)."""
    T = target.shape[-2]
    geo = make_geometry(cfg, T)
    v = valid_frames(valid_t, T)
    state, mag = (x_pad, Y), None
    for _ in range(n_iters):
        state, mag = admm_twin(state, target, window, inv_env, rho, cfg, geo, v)
    stats = _fullrun.eval_sums(mag, target, valid_t) if with_loss else None
    return outputs(*state, mag, stats, emit_state, with_mag, with_loss)


def _launch(x_pad, Y, target, window, inv_env, rho, cfg, n_iters, with_mag,
            with_loss, valid_t):
    """Queue ``n_iters`` kernel iterations; returns (x, Y, mag, stats)."""
    return _fullrun.launch(
        "specinv_admm_iteration", _count, x_pad, Y, target, window, inv_env, rho,
        cfg, n_iters, with_mag, with_loss, valid_t,
    )


class _ADMMRun(torch.autograd.Function):
    """Kernel forward; backward replays the plain twin under autograd."""

    @staticmethod
    def forward(ctx, x_pad, Y, target, window, inv_env, rho, cfg, n_iters,
                with_mag, with_loss, valid_t):
        x, y_out, mag, stats = _launch(
            x_pad, Y, target, window, inv_env, rho, cfg, n_iters, with_mag,
            with_loss, valid_t,
        )
        ctx.save_for_backward(x_pad, Y, target, window, inv_env)
        ctx.scalar, ctx.cfg, ctx.n_iters, ctx.valid_t = rho, cfg, n_iters, valid_t
        extras = [t for t in (mag, stats) if t is not None]
        ctx.mark_non_differentiable(*extras)
        return (x, y_out, *extras)

    @staticmethod
    def backward(ctx, g_x, g_y, *_g_extras):
        grads = _fullrun.replay_backward(ctx, fused_admm_run_reference, g_x, g_y)
        return (*grads, None, None, None, None, None, None)


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
    ``x[, Y][, mag][, stats]``, as in the JAX driver.
    """
    if x_pad.device.type == "cpu":
        return fused_admm_run_reference(
            x_pad, Y, target, window, inv_env, rho, cfg, n_iters,
            emit_state, with_mag, with_loss, valid_t,
        )
    if not supports(cfg, window):
        raise ValueError(
            f"the ADMM kernel needs {UNSUPPORTED} (n_fft={cfg.n_fft}, "
            f"hop={cfg.hop_length})"
        )
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    x, y_out, *extras = _ADMMRun.apply(
        x_pad, Y, target, window, inv_env, float(rho), cfg, n_iters, with_mag,
        with_loss, valid_t,
    )
    mag = extras.pop(0) if with_mag else None
    stats = extras.pop(0) if with_loss else None
    return outputs(x, y_out, mag, stats, emit_state, with_mag, with_loss)
