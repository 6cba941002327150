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
replays ``ops/twins.admm_dft_twin`` at ``'highest'``.  ``_dft`` holds the
dispatch; this module gives it the entry point, the twin, ``rho`` and the
frame count.
"""
from __future__ import annotations

from ...config import STFTConfig
from .. import dft
from ..twins import admm_dft_twin, make_geometry
from . import _dft
from ._dft import UNSUPPORTED, supports  # noqa: F401
from ._fullrun import valid_frames

# Kernel iterations launched (three or four launches each), and of their two
# products those on the persistent kernel (_dft.Kernel), counted by KERNEL.
launches = 0
persistent_products = 0
KERNEL = _dft.Kernel("ADMM", "specinv_admm_dft_iteration", admm_dft_twin, globals())


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
    (x, Y), mag = admm_dft_twin((x_pad, Y), target, window, inv_env, rho, cfg,
                                make_geometry(cfg, T), valid_frames(valid_t, T), _scheme(precision))
    return x, (mag if with_mag else None), Y


def bind(target, window, inv_env, rho, cfg: STFTConfig, valid_t: int = 0, precision="high",
         with_mag: bool = True):
    """:func:`fused_admm_iteration` with all but ``(x_pad, Y)`` bound: a
    function of ``(x_pad, Y)`` with the same contract, whose checks, tables
    and scratch are made once, here (the model driver makes one per run).
    It does not check ``x_pad`` and ``Y``."""
    return _dft.bind(KERNEL, target, window, inv_env, float(rho), cfg,
                     (valid_frames(valid_t, target.shape[-2]),), _scheme(precision), with_mag)[0]


def fused_admm_iteration(x_pad, Y, target, window, inv_env, rho, cfg: STFTConfig,
                         valid_t: int = 0, precision="high", with_mag: bool = True):
    """One DR-ADMM iteration -> ``(x_pad, mag, Y)``: the new signal, the
    pre-update ``|R|`` (None unless ``with_mag``) and the new state.
    ``valid_t`` (0 = all ``T``) zeroes ``Y`` on the frames past it.
    Float32 on the card."""
    return _dft.fused_iteration(KERNEL, x_pad, Y, target, window, inv_env, float(rho), cfg,
                                (valid_frames(valid_t, target.shape[-2]),), _scheme(precision),
                                with_mag)
