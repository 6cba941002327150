"""Griffin-Lim / Fast Griffin-Lim phase reconstruction on PyTorch.

Counterpart of ``specinv_tpu/models/griffin_lim.py`` with the reference's
numerics: momentum factor ``lr = alpha / (1 + alpha)``, projection epsilon
``1e-16``, the pre-momentum magnitude as the metric / stop-criterion output,
and the window^2-envelope ISTFT normalization.

Three backends:

* ``'kernel'``: the hand-written CUDA whole-run kernel
  (``ops/cuda/gl_fullrun``), the counterpart of the JAX ``pallas4`` path
  (``run_tm_pallas4``).  With ``tol == 0`` all iterations are one queue of
  kernel launches; with ``tol > 0`` the run is eval segments of ``eva_iter``
  iterations that emit two reduced sums, then an eval-free tail.  On a CPU
  tensor it runs the kernel's plain version.
* ``'dft'``: the hand-written CUDA direct-DFT iteration kernel on the
  tensor cores (``ops/cuda/gl_fused``), one launch per iteration, the
  counterpart of the JAX ``pallas`` path (``run_tm_pallas``).  It takes the
  precision tiers ``'default'``/``'high'``/``'highest'``/``'bf16x2'``/
  ``'bf16x2t'`` and ``(forward, inverse)`` pairs (``ops/dft.py``); on a CPU
  tensor it runs the kernel's plain version.
* ``'fft'``: the per-iteration ``torch.fft`` path (``run_tm``), the JAX
  ``fft`` backend's counterpart and the speed baseline on the card.

``'auto'`` on a CUDA tensor takes the first that applies, as the JAX order
pallas4 -> pallas -> XLA: ``'kernel'`` where its config check passes,
``'dft'`` where the direct-DFT kernel takes the config and the spectrogram
is real, else ``'fft'`` (decided from the config before any launch).  On
the CPU ``'auto'`` is ``'fft'``.
"""
from __future__ import annotations

import torch

from ..config import STFTConfig
from ..ops.cuda import gl_fullrun, gl_fused
from ..ops.stft import istft, make_envelope, stft
from ..ops.twins import PROJ_EPS
from ..utils.profiling import span
from ..utils.runner import iterate, stop_loss_fn
from ._kernel_driver import run_dft, run_kernel
from .common import prepare, restore_output
from .phase_init import phase_init_tm


def magnitude_project(spec: torch.Tensor, target_mag: torch.Tensor) -> torch.Tensor:
    """Replace ``spec``'s magnitude with ``target_mag``."""
    return spec * (target_mag / (spec.abs() + PROJ_EPS))


def init(target_tm, init_spec_tm, cfg: STFTConfig, window, envelope=None):
    """Initial state ``(x, pre_spec)``."""
    return istft(init_spec_tm, cfg, window, envelope=envelope), init_spec_tm


def step(state, target_tm, lr, cfg: STFTConfig, window, envelope):
    """One Griffin-Lim iteration. Returns (state, pre-momentum magnitude)."""
    x, pre_spec = state
    new_spec = stft(x, cfg, window)
    output = new_spec.abs()
    new_spec = new_spec - pre_spec * lr
    pre_spec = new_spec
    new_spec = magnitude_project(new_spec, target_tm)
    return (istft(new_spec, cfg, window, envelope=envelope), pre_spec), output


def run_tm(target_tm, init_spec_tm, window, lr, tol, cfg: STFTConfig,
           max_iter: int = 200, eva_iter: int = 10, metric: str = "sc",
           verbose: bool = False, mode: str = "fori", early_stop: bool = True,
           remat: bool = False, loss_psum_axes=None) -> torch.Tensor:
    """Time-major Griffin-Lim on ``torch.fft``: target (B, T, F) -> (B, L)."""
    envelope = make_envelope(cfg, window, target_tm.shape[-2])
    state = init(target_tm, init_spec_tm, cfg, window, envelope=envelope)

    def step_fn(st):
        return step(st, target_tm, lr, cfg, window, envelope)

    state = iterate(
        step_fn, state, target_tm, max_iter=max_iter, tol=tol, eva_iter=eva_iter,
        metric=metric, verbose=verbose, mode=mode, early_stop=early_stop,
        remat=remat, loss_fn=stop_loss_fn(loss_psum_axes),
    )
    return state[0]


def run_tm_kernel(*args, **kwargs) -> torch.Tensor:
    """``_kernel_driver.run_kernel`` on kernel A, float32 on every device."""
    return run_kernel(gl_fullrun.fused_gl_run, torch.float32, *args, **kwargs)


def run_tm_dft(*args, **kwargs) -> torch.Tensor:
    """``_kernel_driver.run_dft`` on kernel E."""
    return run_dft(gl_fused.bind, *args, **kwargs)


def seed_spec(spec_tm: torch.Tensor, cfg: STFTConfig):
    """``(cmplx_tm, target_tm)``: a complex spectrogram and its magnitude,
    or the SPSI seed of a magnitude and the magnitude itself."""
    with span("seed"):
        if spec_tm.is_complex():
            return spec_tm, spec_tm.abs()
        return phase_init_tm(spec_tm, cfg), spec_tm


def _full_run(spec_tm, window, lr, tol, cfg, backend, precision=None, **kwargs):
    """Phase seed + loop, from the time-major spectrogram."""
    cmplx_tm, target_tm = seed_spec(spec_tm, cfg)
    if backend == "dft":
        kwargs["precision"] = precision
    run = {"fft": run_tm, "kernel": run_tm_kernel, "dft": run_tm_dft}[backend]
    return run(target_tm, cmplx_tm, window, lr, tol, cfg, **kwargs)


def griffin_lim(
    spec,
    max_iter: int = 200,
    tol: float = 1e-6,
    alpha: float = 0.99,
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
    returns the waveform ``(L,)``/``(B, L)`` on the same device.  ``mode``
    ('fori' keeps the stop decision on the device, 'while' leaves the loop
    at the stop), ``backend`` ('auto'/'kernel'/'dft'/'fft'), ``precision``
    (a tier of ``ops/dft.py`` or a ``(forward, inverse)`` pair on
    ``'dft'``; None, 'high' or 'highest' elsewhere) and ``remat``
    (recompute each iteration in the backward pass) as in the JAX package.
    ``loss_psum_axes`` sums the stop loss over those mesh axes, so that
    every rank of ``parallel.batched(..., global_stop=True)`` stops on the
    global loss (on every backend); ``pack`` is taken on ``'kernel'`` as
    JAX takes it on ``'pallas4'`` (``common.check_pack``) and changes nothing.
    """
    with span("call"):
        with span("prep"):
            if alpha < 0:
                raise ValueError(f"alpha must be >= 0, got {alpha}")
            spec_tm, was_2d, cfg, window, backend, precision = prepare(
                spec, backend, precision, pack, loss_psum_axes, stft_kwargs)
        x = _full_run(
            spec_tm, window, alpha / (1 + alpha), tol, cfg, max_iter=max_iter,
            eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
            backend=backend, early_stop=bool(tol > 0), remat=remat, precision=precision,
            loss_psum_axes=loss_psum_axes,
        )
        with span("synth"):
            return restore_output(x, was_2d)
