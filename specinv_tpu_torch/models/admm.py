"""ADMM phase retrieval (Bregman / proximal-splitting form) on PyTorch.

Counterpart of ``specinv_tpu/models/admm.py``, with the reference's update
order:

    R = stft(x);  Z = (rho*Y + R) / (1 + rho);  U += X - Z
    X = proj_mag(Z - U);  Y = X + U;  x = istft(Y)

with ``rho = 1`` behaving like Griffin-Lim, and the pre-projection magnitude
``|R|`` as the metric / stop-criterion output.

Three backends, chosen as in ``griffin_lim`` (``resolve_backend``):

* ``'kernel'``: the hand-written CUDA whole-run kernel
  (``ops/cuda/admm_fullrun``), the counterpart of the JAX ``pallas4`` path
  (``run_tm_pallas4``).  It carries the Douglas-Rachford one-variable
  reduction of the chain: since ``Y = X + U``, ``U' = U + X - Z = Y - Z`` and
  only ``Y`` persists.  On the card it computes in float32; on a CPU tensor
  it runs the kernel's plain version in the input's precision.
* ``'dft'``: the hand-written CUDA direct-DFT iteration kernel on the
  tensor cores (``ops/cuda/admm_fused``) in the same DR form, one launch per
  iteration, the counterpart of the JAX ``pallas`` path (``run_tm_pallas``).
  It takes one precision tier of ``ops/dft.py`` for both products.  The
  JAX kernel hands ``precision`` to every product whole: a pair holding a
  scheme string raises there (``lax.dot_general`` refuses it), and a pair
  of two ``lax.Precision`` values becomes per-operand precisions, which
  have no counterpart here, so the port raises for every pair.
* ``'fft'``: the literal ``(X, Y, U, x)`` chain on ``torch.fft``
  (``run_tm``), the parity anchor and the speed baseline on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import STFTConfig
from ..ops import dft
from ..ops.cuda import admm_fullrun, admm_fused
from ..ops.framing import pad_center
from ..ops.stft import istft, make_envelope, stft
from ..utils.profiling import span
from ..utils.runner import iterate, stop_loss_fn
from ._kernel_driver import make_geometry, make_inv_env, run_kernel_loop
from .common import prepare_spec_b3, restore_output
from .griffin_lim import (
    check_args, check_pack, magnitude_project, resolve_backend, seed_spec, time_major,
)


class ADMMState(NamedTuple):
    X: torch.Tensor  # (B, T, F) complex, projection-side variable
    Y: torch.Tensor  # (B, T, F) complex, synthesis-side variable
    U: torch.Tensor  # (B, T, F) complex, scaled dual variable
    x: torch.Tensor  # (B, L) waveform


def init(init_spec_tm, cfg: STFTConfig, window, envelope=None) -> ADMMState:
    """Initial state: ``X = Y`` = the seeded spectrum, ``U = 0``."""
    x = istft(init_spec_tm, cfg, window, envelope=envelope)
    return ADMMState(X=init_spec_tm, Y=init_spec_tm,
                     U=torch.zeros_like(init_spec_tm), x=x)


def step(state, target_tm, rho, cfg: STFTConfig, window, envelope):
    """One ADMM iteration. Returns (state, pre-projection magnitude)."""
    X, Y, U, x = state  # the runner may hand back a plain tuple
    R = stft(x, cfg, window)
    output = R.abs()
    Z = (rho * Y + R) / (1 + rho)
    U = U + X - Z
    X = magnitude_project(Z - U, target_tm)
    Y = X + U
    x = istft(Y, cfg, window, envelope=envelope)
    return ADMMState(X=X, Y=Y, U=U, x=x), output


def run_tm(target_tm, init_spec_tm, window, rho, tol, cfg: STFTConfig,
           max_iter: int = 1000, eva_iter: int = 10, metric: str = "sc",
           verbose: bool = False, mode: str = "fori", early_stop: bool = True,
           remat: bool = False, loss_psum_axes=None) -> torch.Tensor:
    """Time-major ADMM on ``torch.fft``, the literal (X, Y, U, x) chain:
    target (B, T, F) -> (B, L)."""
    envelope = make_envelope(cfg, window, target_tm.shape[-2])
    state = init(init_spec_tm, cfg, window, envelope=envelope)

    def step_fn(st):
        return step(st, target_tm, rho, cfg, window, envelope)

    state = iterate(
        step_fn, state, target_tm, max_iter=max_iter, tol=tol, eva_iter=eva_iter,
        metric=metric, verbose=verbose, mode=mode, early_stop=early_stop,
        remat=remat, loss_fn=stop_loss_fn(loss_psum_axes),
    )
    return state[3]


def run_tm_kernel(target_tm, init_spec_tm, window, rho, tol, cfg: STFTConfig,
                  max_iter: int = 1000, eva_iter: int = 10, metric: str = "sc",
                  verbose: bool = False, mode: str = "fori",
                  early_stop: bool = True, remat: bool = False,
                  loss_psum_axes=None) -> torch.Tensor:
    """ADMM through the whole-run kernel in the DR form, the counterpart of
    the JAX ``run_tm_pallas4``: target (B, T, F) -> (B, L).

    The initial state is ``Y0`` = the seed (``U0 = 0``) and ``x0 =
    istft(seed)`` in padded coordinates.  The kernel takes float32; for CPU
    tensors its plain version keeps the input's precision, which lets the DR
    form be held to the literal chain in float64.
    """
    T = target_tm.shape[-2]
    with span("seed"):
        geo = make_geometry(cfg, T)
        real = torch.float32 if target_tm.is_cuda else target_tm.dtype
        win = window.to(real)
        inv_env = make_inv_env(cfg, win, T, geo)
        target = target_tm.to(real).contiguous()
        y0 = init_spec_tm.to(torch.complex64 if real == torch.float32 else torch.complex128)
        x_pad0 = pad_center(istft(init_spec_tm, cfg, window).to(real), cfg)

    def run(state, n_iters, **flags):
        return admm_fullrun.fused_admm_run(
            state[0], state[1], target, win, inv_env, rho, cfg, n_iters, **flags)

    return run_kernel_loop(
        run, (x_pad0, y0), target, geo, max_iter=max_iter, tol=tol,
        eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
        early_stop=early_stop, remat=remat, loss_psum_axes=loss_psum_axes,
    )


def run_tm_dft(target_tm, init_spec_tm, window, rho, tol, cfg: STFTConfig,
               max_iter: int = 1000, eva_iter: int = 10, metric: str = "sc",
               verbose: bool = False, mode: str = "fori", early_stop: bool = True,
               remat: bool = False, precision="high", loss_psum_axes=None) -> torch.Tensor:
    """ADMM through the direct-DFT iteration kernel in the DR form (float32),
    the counterpart of the JAX ``admm.run_tm_pallas``: target (B, T, F) ->
    (B, L).  One launch per iteration under ``utils/runner.iterate``, the
    magnitude plane as the eval output; ``mode`` is honoured (JAX pins
    ``'fori'``; the two give the same result).  ``Y0`` is the seed (``U0 =
    0``), every frame valid.  Spans as ``griffin_lim.run_tm_dft``'s.
    """
    T = target_tm.shape[-2]
    with span("seed"):
        geo = make_geometry(cfg, T)
        win32 = window.float()
        inv_env = make_inv_env(cfg, win32, T, geo)
        target = target_tm.float().contiguous()
        x_pad0 = pad_center(istft(init_spec_tm, cfg, window).float(), cfg)
    with_mag = verbose or (early_stop and not (isinstance(tol, (int, float)) and tol == 0))

    with span("loop"):
        iteration = admm_fused.bind(target, win32, inv_env, rho, cfg, T, precision, with_mag)

        def step_fn(state):
            x, mag, y = iteration(*state)
            return (x, y), mag

        state = iterate(
            step_fn, (x_pad0, init_spec_tm.to(torch.complex64)), target, max_iter=max_iter,
            tol=tol, eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
            early_stop=early_stop, remat=remat, loss_fn=stop_loss_fn(loss_psum_axes),
        )
    with span("synth"):
        return state[0][..., geo.p_amt : geo.p_amt + geo.l_out]


def _full_run(spec_tm, window, rho, tol, cfg, max_iter, eva_iter, metric,
              verbose, mode, backend, early_stop, remat, precision=None,
              loss_psum_axes=None):
    """Phase seed + loop, from the time-major spectrogram."""
    cmplx_tm, target_tm = seed_spec(spec_tm, cfg)
    if backend == "dft":
        return run_tm_dft(
            target_tm, cmplx_tm, window, rho, tol, cfg, max_iter=max_iter,
            eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
            early_stop=early_stop, remat=remat, precision=precision,
            loss_psum_axes=loss_psum_axes,
        )
    run = run_tm_kernel if backend == "kernel" else run_tm
    return run(
        target_tm, cmplx_tm, window, rho, tol, cfg, max_iter=max_iter,
        eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
        early_stop=early_stop, remat=remat, loss_psum_axes=loss_psum_axes,
    )


def ADMM(
    spec,
    max_iter: int = 1000,
    tol: float = 1e-6,
    rho: float = 0.1,
    verbose: bool = True,
    eva_iter: int = 10,
    metric: str = "sc",
    mode: str = "fori",
    backend: str = "auto",
    precision=None,
    loss_psum_axes=None,
    pack: int | None = None,
    remat: bool = False,
    **stft_kwargs,
):
    """Reference-parity entry point.

    Accepts a magnitude or complex spectrogram ``(F, T)``/``(B, F, T)`` (a
    tensor on any device, or an array) plus the torch.stft kwarg space, and
    returns the waveform ``(L,)``/``(B, L)`` on the same device.  ``mode``,
    ``backend`` ('auto'/'kernel'/'dft'/'fft'), ``precision`` and ``remat``
    as on :func:`griffin_lim`, except that ``'dft'`` takes one precision
    tier, not a ``(forward, inverse)`` pair (see the module docstring);
    ``loss_psum_axes`` and ``pack`` as on :func:`griffin_lim`.
    """
    with span("call"):
        with span("prep"):
            if not (eva_iter > 0 and max_iter > 0 and tol >= 0):
                raise ValueError(
                    f"need eva_iter > 0, max_iter > 0 and tol >= 0 "
                    f"(got {eva_iter}, {max_iter}, {tol})"
                )
            check_args(stft_kwargs, loss_psum_axes)
            spec_b3, was_2d, cfg, window = prepare_spec_b3(spec, **stft_kwargs)
            backend = resolve_backend(backend, cfg, window, spec_b3.device,
                                      spec_b3.is_complex())
            check_pack(pack, backend, spec_b3.shape[0])
            precision = dft.check_precision(precision, backend)
            spec_tm = time_major(spec_b3)
        x = _full_run(
            spec_tm, window, rho, tol, cfg, max_iter=max_iter, eva_iter=eva_iter,
            metric=metric, verbose=verbose, mode=mode, backend=backend,
            early_stop=bool(tol > 0), remat=remat, precision=precision,
            loss_psum_axes=loss_psum_axes,
        )
        with span("synth"):
            return restore_output(x, was_2d)


admm = ADMM
