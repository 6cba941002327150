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

import numbers

import torch

from ..config import STFT_KWARG_NAMES, STFTConfig
from ..ops import dft, fourier
from ..ops.cuda import _dft, gl_fullrun, gl_fused
from ..ops.framing import pad_center
from ..ops.stft import istft, make_envelope, stft
from ..utils.profiling import span
from ..utils.runner import iterate, stop_loss_fn
from ._kernel_driver import PROJ_EPS, make_geometry, make_inv_env, run_kernel_loop
from .common import prepare_spec_b3, restore_output
from .phase_init import phase_init_tm

BACKENDS = ("auto", "kernel", "dft", "fft")


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


def run_tm_kernel(target_tm, init_spec_tm, window, lr, tol, cfg: STFTConfig,
                  max_iter: int = 200, eva_iter: int = 10, metric: str = "sc",
                  verbose: bool = False, mode: str = "fori",
                  early_stop: bool = True, remat: bool = False,
                  loss_psum_axes=None) -> torch.Tensor:
    """Griffin-Lim through the whole-run kernel (float32), the counterpart of
    the JAX ``run_tm_pallas4``: target (B, T, F) -> (B, L)."""
    T = target_tm.shape[-2]
    with span("seed"):
        geo = make_geometry(cfg, T)
        win32 = window.float()
        inv_env = make_inv_env(cfg, win32, T, geo)
        target = target_tm.float().contiguous()
        pre0 = init_spec_tm.to(torch.complex64)
        x_pad0 = pad_center(istft(init_spec_tm, cfg, window).float(), cfg)

    def run(state, n_iters, **flags):
        return gl_fullrun.fused_gl_run(
            state[0], state[1], target, win32, inv_env, lr, cfg, n_iters, **flags)

    return run_kernel_loop(
        run, (x_pad0, pre0), target, geo, max_iter=max_iter, tol=tol,
        eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
        early_stop=early_stop, remat=remat, loss_psum_axes=loss_psum_axes,
    )


def run_tm_dft(target_tm, init_spec_tm, window, lr, tol, cfg: STFTConfig,
               max_iter: int = 200, eva_iter: int = 10, metric: str = "sc",
               verbose: bool = False, mode: str = "fori", early_stop: bool = True,
               remat: bool = False, precision="high", loss_psum_axes=None) -> torch.Tensor:
    """Griffin-Lim through the direct-DFT iteration kernel (float32), the
    counterpart of the JAX ``run_tm_pallas``: target (B, T, F) -> (B, L).

    One kernel launch per iteration under ``utils/runner.iterate``, with the
    magnitude plane as the eval output (written only when a run evaluates).
    JAX pins ``mode='fori'`` here; the port's two modes give the same
    result, so ``mode`` is honoured.  Spans as :func:`run_tm_kernel`'s: the
    first inverse in ``specinv.seed``, the loop in ``specinv.loop`` (each
    iteration's launch in ``specinv.launch``), the trim in ``specinv.synth``.
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
        iteration = gl_fused.bind(target, win32, inv_env, lr, cfg, precision, with_mag)

        def step_fn(state):
            x, mag, pre = iteration(*state)
            return (x, pre), mag

        state = iterate(
            step_fn, (x_pad0, init_spec_tm.to(torch.complex64)), target, max_iter=max_iter,
            tol=tol, eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
            early_stop=early_stop, remat=remat, loss_fn=stop_loss_fn(loss_psum_axes),
        )
    with span("synth"):
        return state[0][..., geo.p_amt : geo.p_amt + geo.l_out]


def time_major(spec_b3: torch.Tensor) -> torch.Tensor:
    """The ``(B, T, F)`` view the drivers take, 16-bit floats as float32."""
    if spec_b3.dtype in (torch.bfloat16, torch.float16):
        spec_b3 = spec_b3.float()
    return spec_b3.transpose(-1, -2)


def seed_spec(spec_tm: torch.Tensor, cfg: STFTConfig):
    """``(cmplx_tm, target_tm)``: a complex spectrogram and its magnitude,
    or the SPSI seed of a magnitude and the magnitude itself."""
    with span("seed"):
        if spec_tm.is_complex():
            return spec_tm, spec_tm.abs()
        return phase_init_tm(spec_tm, cfg), spec_tm


def _full_run(spec_tm, window, lr, tol, cfg, max_iter, eva_iter, metric,
              verbose, mode, backend, early_stop, remat, precision=None,
              loss_psum_axes=None):
    """Phase seed + loop, from the time-major spectrogram."""
    cmplx_tm, target_tm = seed_spec(spec_tm, cfg)
    if backend == "dft":
        return run_tm_dft(
            target_tm, cmplx_tm, window, lr, tol, cfg, max_iter=max_iter,
            eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
            early_stop=early_stop, remat=remat, precision=precision,
            loss_psum_axes=loss_psum_axes,
        )
    run = run_tm_kernel if backend == "kernel" else run_tm
    return run(
        target_tm, cmplx_tm, window, lr, tol, cfg, max_iter=max_iter,
        eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
        early_stop=early_stop, remat=remat, loss_psum_axes=loss_psum_axes,
    )


def resolve_backend(backend: str, cfg: STFTConfig, window, device,
                    is_complex: bool = False) -> str:
    """``'auto'`` on CUDA -> ``'kernel'`` when the whole-run kernels take
    ``cfg``, else ``'dft'`` when the direct-DFT kernels take it and the
    spectrogram is real (``is_complex`` False), else ``'fft'``; on the CPU
    ``'fft'``.  Decided from the config, before any launch.  Shared by
    ``griffin_lim`` and ``ADMM``."""
    fourier.check_not_xla_lowering(backend, direct_dft=True)
    if backend in ("pallas", "pallas4"):
        raise ValueError(
            f"backend {backend!r} is a TPU kernel; the port's counterparts are 'dft' "
            "(JAX 'pallas') and 'kernel' (JAX 'pallas4')")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    ok, dft_ok = gl_fullrun.supports(cfg, window), _dft.supports(cfg, window)
    if backend == "auto":
        if device.type != "cuda":
            return "fft"
        return "kernel" if ok else ("dft" if dft_ok and not is_complex else "fft")
    if backend == "kernel" and not ok:
        raise ValueError(
            f"the kernel backend needs {gl_fullrun.UNSUPPORTED}; use backend='auto' instead"
        )
    if backend == "dft" and not dft_ok:
        raise ValueError(
            f"the dft backend needs {_dft.UNSUPPORTED}; use backend='auto' instead"
        )
    return backend


def check_args(stft_kwargs, loss_psum_axes) -> None:
    """The backend-free argument checks ``griffin_lim`` and ``ADMM`` share.
    ``loss_psum_axes`` must name axes of the mesh the caller bound
    (``parallel.batched``)."""
    unknown = set(stft_kwargs) - set(STFT_KWARG_NAMES)
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    stop_loss_fn(loss_psum_axes)


def check_pack(pack, backend: str, batch: int) -> None:
    """JAX's rule for ``pack`` on the resolved backend.  The TPU kernel
    folds ``pack`` clips into each grid step, bitwise invariant; here one
    launch already covers every clip, so on ``'kernel'`` (the JAX
    ``'pallas4'``) a valid ``pack`` changes nothing.  Elsewhere it raises."""
    if pack is None:
        return
    if backend != "kernel":
        raise ValueError(
            f"pack applies to the whole-run pallas4 kernel only (the port's 'kernel'; "
            f"resolved backend here: {backend!r})"
        )
    if isinstance(pack, bool) or not isinstance(pack, numbers.Integral) or pack < 1 or batch % pack:
        raise ValueError(f"pack={pack} must be >= 1 and divide the batch size {batch}")


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
    JAX takes it on ``'pallas4'`` (:func:`check_pack`) and changes nothing.
    """
    with span("call"):
        with span("prep"):
            if alpha < 0:
                raise ValueError(f"alpha must be >= 0, got {alpha}")
            check_args(stft_kwargs, loss_psum_axes)
            spec_b3, was_2d, cfg, window = prepare_spec_b3(spec, **stft_kwargs)
            backend = resolve_backend(backend, cfg, window, spec_b3.device,
                                      spec_b3.is_complex())
            check_pack(pack, backend, spec_b3.shape[0])
            precision = dft.check_precision(precision, backend)
            spec_tm = time_major(spec_b3)
        x = _full_run(
            spec_tm, window, alpha / (1 + alpha), tol, cfg, max_iter=max_iter,
            eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
            backend=backend, early_stop=bool(tol > 0), remat=remat, precision=precision,
            loss_psum_axes=loss_psum_axes,
        )
        with span("synth"):
            return restore_output(x, was_2d)
