"""ADMM phase retrieval (Bregman / proximal-splitting form) on PyTorch.

Counterpart of ``specinv_tpu/models/admm.py``, with the reference's update
order:

    R = stft(x);  Z = (rho*Y + R) / (1 + rho);  U += X - Z
    X = proj_mag(Z - U);  Y = X + U;  x = istft(Y)

with ``rho = 1`` behaving like Griffin-Lim, and the pre-projection magnitude
``|R|`` as the metric / stop-criterion output.

Three backends, chosen as in ``griffin_lim`` (``common.resolve_backend``):

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
from ..ops.cuda import admm_fullrun, admm_fused
from ..ops.stft import istft, make_envelope, stft
from ..utils.profiling import span
from ..utils.runner import iterate, stop_loss_fn
from ._kernel_driver import run_dft, run_kernel
from .common import prepare, restore_output
from .griffin_lim import magnitude_project, seed_spec


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


def run_tm_kernel(*args, **kwargs) -> torch.Tensor:
    """``_kernel_driver.run_kernel`` on kernel C.  On CPU tensors its plain
    version keeps the input's precision, which lets the DR form be held to
    the literal chain in float64."""
    return run_kernel(admm_fullrun.fused_admm_run, None, *args, **kwargs)


def run_tm_dft(*args, **kwargs) -> torch.Tensor:
    """``_kernel_driver.run_dft`` on kernel F, every frame valid."""
    return run_dft(admm_fused.bind, *args, **kwargs)


def _full_run(spec_tm, window, rho, tol, cfg, backend, precision=None, **kwargs):
    """Phase seed + loop, from the time-major spectrogram."""
    cmplx_tm, target_tm = seed_spec(spec_tm, cfg)
    if backend == "dft":
        kwargs["precision"] = precision
    run = {"fft": run_tm, "kernel": run_tm_kernel, "dft": run_tm_dft}[backend]
    return run(target_tm, cmplx_tm, window, rho, tol, cfg, **kwargs)


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
            spec_tm, was_2d, cfg, window, backend, precision = prepare(
                spec, backend, precision, pack, loss_psum_axes, stft_kwargs)
        x = _full_run(
            spec_tm, window, rho, tol, cfg, max_iter=max_iter, eva_iter=eva_iter,
            metric=metric, verbose=verbose, mode=mode, backend=backend,
            early_stop=bool(tol > 0), remat=remat, precision=precision,
            loss_psum_axes=loss_psum_axes,
        )
        with span("synth"):
            return restore_output(x, was_2d)


admm = ADMM
