"""One direct-DFT ADMM iteration: the CUDA kernel, its plain version, its
gradient.

``csrc/admm_fused.cu`` (on the engine ``csrc/dft_iter.cuh``) replaces the
TPU kernel ``specinv_tpu/ops/pallas/admm_fused.py::_kernel``, launched by
that module's ``fused_admm_iteration``, which carries ``ADMM(backend=
'pallas')``.  :func:`fused_admm_iteration` keeps its contract ``(x_pad,
mag, Y)`` in the port's layout: the signal ``x_pad (B, lp)`` in padded
coordinates and the Douglas-Rachford state ``Y`` as one complex ``(B, T,
F)`` plane in natural bin order (``convert.dft_state_from_jax`` carries the
JAX ``Y_re``/``Y_im`` planes across).

``precision`` is one scheme of ``ops/dft.py``: the JAX kernel hands its
precision to every product whole, so it has no per-direction pair.  On a
CPU tensor it runs :func:`fused_admm_iteration_reference`; on a CUDA tensor
it launches the kernel once, with no host sync, or raises.  :func:`bind`
makes the checks, tables and scratch of a run once.  The gradient
replays ``models/_kernel_driver.admm_dft_twin`` at ``'highest'``.
"""
from __future__ import annotations

from ...config import STFTConfig
from ...models._kernel_driver import admm_dft_twin, make_geometry
from .. import dft
from . import _dft
from ._dft import UNSUPPORTED, supports  # noqa: F401
from ._fullrun import valid_frames

# Kernel iterations launched (three or four launches each).
launches = 0


def _count():
    global launches
    launches += 1


def _scheme(precision) -> str:
    precision = dft.check_precision(precision, "dft")
    if isinstance(precision, tuple):
        raise ValueError("the ADMM kernel takes one precision for both products, not a pair")
    return precision


def fused_admm_iteration_reference(x_pad, Y, target, window, inv_env, rho, cfg: STFTConfig,
                                   valid_t: int = 0, precision="high", with_mag: bool = True):
    """Plain PyTorch version of :func:`fused_admm_iteration` (same
    contract), in ``x_pad``'s type."""
    T = target.shape[-2]
    geo = make_geometry(cfg, T)
    (x, Y), mag = admm_dft_twin((x_pad, Y), target, window, inv_env, rho, cfg, geo,
                                valid_frames(valid_t, T), _scheme(precision))
    return x, (mag if with_mag else None), Y


def _bound(target, window, inv_env, rho, cfg: STFTConfig, valid_t, precision, with_mag):
    """``(iteration, run)``: :func:`bind`'s function and the kernel's
    :class:`_dft.Launch` (None for tensors on the CPU)."""
    precision = _scheme(precision)
    T = target.shape[-2]
    geo, v = make_geometry(cfg, T), valid_frames(valid_t, T)
    run = None
    if target.device.type == "cpu":
        def step(*t):
            return fused_admm_iteration_reference(*t, rho, cfg, v, precision, with_mag)
    else:
        if not supports(cfg, window):
            raise ValueError(f"the direct-DFT ADMM kernel needs {UNSUPPORTED} "
                             f"(n_fft={cfg.n_fft}, hop={cfg.hop_length})")
        run = _dft.Launch("specinv_admm_dft_iteration", _count, target, window, inv_env, cfg,
                          precision, with_mag, (float(rho), v))

        def step(x_pad, y, *_):
            return run(x_pad, y)

    def replay(x, y, *rest):
        return admm_dft_twin((x, y), *rest, rho, cfg, geo, v, "highest")

    def iteration(x_pad, Y):
        return _dft.iterate_once(step, replay, x_pad, Y, target, window, inv_env, with_mag)

    return iteration, run


def bind(target, window, inv_env, rho, cfg: STFTConfig, valid_t: int = 0, precision="high",
         with_mag: bool = True):
    """:func:`fused_admm_iteration` with all but ``(x_pad, Y)`` bound: a
    function of ``(x_pad, Y)`` with the same contract, whose checks, tables
    and scratch are made once, here (``run_tm_dft`` makes one per run).
    It does not check ``x_pad`` and ``Y``."""
    return _bound(target, window, inv_env, rho, cfg, valid_t, precision, with_mag)[0]


def fused_admm_iteration(x_pad, Y, target, window, inv_env, rho, cfg: STFTConfig,
                         valid_t: int = 0, precision="high", with_mag: bool = True):
    """One DR-ADMM iteration -> ``(x_pad, mag, Y)``: the new signal, the
    pre-update ``|R|`` (None unless ``with_mag``) and the new state.
    ``valid_t`` (0 = all ``T``) zeroes ``Y`` on the frames past it.
    Float32 on the card."""
    iteration, run = _bound(target, window, inv_env, rho, cfg, valid_t, precision, with_mag)
    if run is not None:
        run.check(x_pad=x_pad, state=Y)
    return iteration(x_pad, Y)
