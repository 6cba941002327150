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
CUDA tensor it launches the kernel once, with no host sync, or raises.  The
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

# Kernel iterations launched (three launches each).
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


def fused_gl_iteration(x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig,
                       precision="high", with_mag: bool = True):
    """One Griffin-Lim iteration -> ``(x_pad, mag, pre)``: the new signal,
    the pre-momentum ``|S|`` (None unless ``with_mag``) and the new
    momentum.  Float32 on the card."""
    precision = dft.check_precision(precision, "dft")
    geo = make_geometry(cfg, target.shape[-2])
    if x_pad.device.type == "cpu":
        def step(*t):
            return fused_gl_iteration_reference(*t, lr, cfg, precision, with_mag)
    else:
        if not supports(cfg, window):
            raise ValueError(f"the direct-DFT Griffin-Lim kernel needs {UNSUPPORTED} "
                             f"(n_fft={cfg.n_fft}, hop={cfg.hop_length})")

        def step(*t):
            return _dft.launch("specinv_gl_dft_iteration", _count, *t, cfg, precision,
                               with_mag, (float(lr),))

    def replay(x, p, *rest):
        return gl_dft_twin((x, p), *rest, lr, cfg, geo, "highest")

    return _dft.iterate_once(step, replay, x_pad, pre, target, window, inv_env, with_mag)
