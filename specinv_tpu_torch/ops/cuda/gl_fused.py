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
gradient replays the plain twin (``ops/twins.gl_dft_twin``) at
``'highest'`` under autograd, as the JAX ``custom_vjp`` replays
``gl_xla_twin`` at HIGHEST for a scheme string.  ``_dft`` holds the
dispatch; this module gives it the entry point, the twin and ``lr``.
"""
from __future__ import annotations

from ...config import STFTConfig
from .. import dft
from ..twins import gl_dft_twin, make_geometry
from . import _dft
from ._dft import UNSUPPORTED, supports  # noqa: F401

# Kernel iterations launched (three or four launches each), and of their two
# products those on the persistent kernel (_dft.Kernel), counted by KERNEL.
launches = 0
persistent_products = 0
KERNEL = _dft.Kernel("Griffin-Lim", "specinv_gl_dft_iteration", gl_dft_twin, globals())


def fused_gl_iteration_reference(x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig,
                                 precision="high", with_mag: bool = True):
    """Plain PyTorch version of :func:`fused_gl_iteration` (same contract),
    in ``x_pad``'s type."""
    geo = make_geometry(cfg, target.shape[-2])
    (x, pre), mag = gl_dft_twin((x_pad, pre), target, window, inv_env, lr, cfg, geo, precision)
    return x, (mag if with_mag else None), pre


def bind(target, window, inv_env, lr, cfg: STFTConfig, precision="high",
         with_mag: bool = True):
    """:func:`fused_gl_iteration` with all but ``(x_pad, pre)`` bound: a
    function of ``(x_pad, pre)`` with the same contract, whose checks,
    tables and scratch are made once, here (the model driver makes one per
    run).  It does not check ``x_pad`` and ``pre``."""
    return _dft.bind(KERNEL, target, window, inv_env, float(lr), cfg, (),
                     dft.check_precision(precision, "dft"), with_mag)[0]


def fused_gl_iteration(x_pad, pre, target, window, inv_env, lr, cfg: STFTConfig,
                       precision="high", with_mag: bool = True):
    """One Griffin-Lim iteration -> ``(x_pad, mag, pre)``: the new signal,
    the pre-momentum ``|S|`` (None unless ``with_mag``) and the new
    momentum.  Float32 on the card."""
    return _dft.fused_iteration(KERNEL, x_pad, pre, target, window, inv_env, float(lr), cfg, (),
                                dft.check_precision(precision, "dft"), with_mag)
