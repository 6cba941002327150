"""One direct-DFT Griffin-Lim iteration: the CUDA kernel, its plain
version, its gradient.

``csrc/gl_fused.cu`` (on the engine ``csrc/dft_iter.cuh``) replaces the TPU
kernel ``specinv_tpu/ops/pallas/gl_fused.py::_kernel``, launched by that
module's ``fused_gl_iteration``, which carries ``griffin_lim(backend=
'pallas')``.  :func:`fused_gl_iteration` keeps its contract ``(x_pad, mag,
state)`` in the port's layout: the signal ``x_pad (B, lp)`` in padded
coordinates, the momentum ``pre`` as one complex ``(B, T, F)`` plane in
natural bin order (``convert.dft_state_from_jax`` carries the JAX
``pre_re``/``pre_im`` planes across), with no padded rows or bins.

``precision`` is a scheme of ``ops/dft.py`` or a ``(forward, inverse)``
pair.  On a CPU tensor it runs :func:`fused_gl_iteration_reference`; on a
CUDA tensor it launches the kernel once, with no host sync, or raises.
:func:`bind` makes the checks, tables and scratch of a run once.  The
gradient replays the plain twin (``models/_kernel_driver.gl_dft_twin``) at
``'highest'`` under autograd, as the JAX ``custom_vjp`` replays
``gl_xla_twin`` at HIGHEST for a scheme string.
"""
from __future__ import annotations

from ...config import STFTConfig
from ...models._kernel_driver import gl_dft_twin, make_geometry
from .. import dft
from . import _dft
from ._dft import UNSUPPORTED, supports  # noqa: F401

# Kernel iterations launched (three or four launches each).
launches = 0


def _count():
    global launches
    launches += 1


def fused_gl_iteration_reference(x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig,
                                 precision="high", with_mag: bool = True):
    """Plain PyTorch version of :func:`fused_gl_iteration` (same contract),
    in ``x_pad``'s type."""
    geo = make_geometry(cfg, target.shape[-2])
    (x, pre), mag = gl_dft_twin((x_pad, pre), target, window, inv_env, lr, cfg, geo, precision)
    return x, (mag if with_mag else None), pre


def _bound(target, window, inv_env, lr, cfg: STFTConfig, precision, with_mag):
    """``(iteration, run)``: :func:`bind`'s function and the kernel's
    :class:`_dft.Launch` (None for tensors on the CPU)."""
    precision = dft.check_precision(precision, "dft")
    geo = make_geometry(cfg, target.shape[-2])
    run = None
    if target.device.type == "cpu":
        def step(*t):
            return fused_gl_iteration_reference(*t, lr, cfg, precision, with_mag)
    else:
        if not supports(cfg, window):
            raise ValueError(f"the direct-DFT Griffin-Lim kernel needs {UNSUPPORTED} "
                             f"(n_fft={cfg.n_fft}, hop={cfg.hop_length})")
        run = _dft.Launch("specinv_gl_dft_iteration", _count, target, window, inv_env, cfg,
                          precision, with_mag, (float(lr),))

        def step(x_pad, pre, *_):
            return run(x_pad, pre)

    def replay(x, p, *rest):
        return gl_dft_twin((x, p), *rest, lr, cfg, geo, "highest")

    def iteration(x_pad, pre):
        return _dft.iterate_once(step, replay, x_pad, pre, target, window, inv_env, with_mag)

    return iteration, run


def bind(target, window, inv_env, lr, cfg: STFTConfig, precision="high",
         with_mag: bool = True):
    """:func:`fused_gl_iteration` with all but ``(x_pad, pre)`` bound: a
    function of ``(x_pad, pre)`` with the same contract, whose checks,
    tables and scratch are made once, here (``run_tm_dft`` makes one per
    run).  It does not check ``x_pad`` and ``pre``."""
    return _bound(target, window, inv_env, lr, cfg, precision, with_mag)[0]


def fused_gl_iteration(x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig,
                       precision="high", with_mag: bool = True):
    """One Griffin-Lim iteration -> ``(x_pad, mag, pre)``: the new signal,
    the pre-momentum ``|S|`` (None unless ``with_mag``) and the new
    momentum.  Float32 on the card."""
    iteration, run = _bound(target, window, inv_env, lr, cfg, precision, with_mag)
    if run is not None:
        run.check(x_pad=x_pad, state=pre)
    return iteration(x_pad, pre)
