"""Whole-run Griffin-Lim: the CUDA kernel, its plain version, its gradient.

``csrc/gl_fullrun.cu`` replaces the TPU kernels
``specinv_tpu/ops/pallas/fullrun_lane.py::_kernel`` (``algo='gl'``) and
``gl_fullrun4.py::_kernel`` (the (m, 128) layout, taken when hop does not
divide n_fft), both driven as ``gl_fullrun4.fused_gl_run``.
:func:`fused_gl_run` keeps that driver's contract in the port's layout: the
signal ``x_pad (B, lp)`` in padded coordinates, the momentum ``pre`` and the
target as ``(B, T, F)`` onesided planes in natural bin order; it runs
``n_iters`` iterations, and ``mag`` is the pre-momentum ``|S|``.

:func:`fused_gl_iteration` is one launch of the same C entry point that
stops at the raw overlap-add (no envelope, no re-pad), the counterpart of
``gl_fused4.fused_gl_iteration4`` (``gl_fused4.py::_kernel``, one iteration
per launch) with ``normalize=False``, the form the sequence-parallel path
calls.

The four public functions are the methods of :data:`KERNEL`
(``_fullrun.Kernel``, which gives their contract and holds the dispatch);
this module gives it the entry point, the twin and the counters.  On a CPU
tensor they run their plain version; on a CUDA tensor they queue kernel
iterations on the current stream with no host sync, or raise.  Gradients
flow through ``_fullrun.Run``, whose backward replays the plain twin
(``ops/twins.gl_twin``) under autograd, as the JAX package's
``custom_vjp`` replays ``gl_xla_twin4``.
"""
from __future__ import annotations

from ..twins import gl_twin
from . import _fullrun
from ._fullrun import UNSUPPORTED, supports  # noqa: F401  (read here by seq.py and the tests)

# Kernel iterations launched (one frame + one OLA launch each) by the whole
# run, and by the raw per-iteration dispatch; and of both, those whose frame
# launch took the many-wave plan (_fullrun.frame_plan).  KERNEL counts them
# in this module's namespace.
launches = 0
iteration_launches = 0
many_wave_launches = 0


def _twin(state, target, window, inv_env, lr, cfg, geo, valid_t):
    """:func:`gl_twin`: the eval sums alone read ``valid_t``."""
    return gl_twin(state, target, window, inv_env, lr, cfg, geo)


KERNEL = _fullrun.Kernel("Griffin-Lim", "specinv_gl_iteration", _twin, globals())
fused_gl_run = KERNEL.run
fused_gl_iteration = KERNEL.iteration
fused_gl_run_reference = KERNEL.run_reference
fused_gl_iteration_reference = KERNEL.iteration_reference
