"""Whole-run ADMM: the CUDA kernel, its plain version, its gradient.

``csrc/admm_fullrun.cu`` replaces the TPU kernels
``specinv_tpu/ops/pallas/fullrun_lane.py::_kernel`` (``algo='admm'``) and
``admm_fused4.py::_kernel_full``, both driven as
``admm_fused4.fused_admm_run``.  :func:`fused_admm_run` keeps that driver's
contract in the port's layout: the signal ``x_pad (B, lp)`` in padded
coordinates, the Douglas-Rachford state ``Y`` and the target as ``(B, T, F)``
planes in natural bin order (``convert.state_from_jax`` carries the JAX
``Y_re``/``Y_im`` planes across).  It runs ``n_iters`` DR-ADMM iterations
from the reference's ``Y = X`` = the seeded spectrum, ``U = 0``; ``mag`` is
the pre-update ``|R|``, and ``valid_t`` (0 = all ``T``) also zeroes ``Y`` on
the frames past it.

:func:`fused_admm_iteration` is one launch of the same C entry point that
stops at the raw overlap-add, the counterpart of
``admm_fused4.fused_admm_iteration4`` (``admm_fused4.py::_kernel_iter``,
one iteration per launch, a row count that differs per shard) with
``normalize=False``, the form the sequence-parallel path calls.  Its
``valid_t`` counts the frames that keep their ``Y`` and enter the eval
sums: None for all ``T``, 0 for none.

The four public functions are the methods of :data:`KERNEL`
(``_fullrun.Kernel``, which gives their contract and holds the dispatch);
this module gives it the entry point, the twin and the counters.  On a CPU
tensor they run their plain version; on a CUDA tensor they queue kernel
iterations on the current stream with no host sync, or raise.  Gradients
flow through ``_fullrun.Run``, whose backward replays the plain twin
(``ops/twins.admm_twin``, which zeroes ``Y`` past ``valid_t``) under
autograd, as the JAX package's ``custom_vjp`` replays ``admm_xla_twin4``.
"""
from __future__ import annotations

from ..twins import admm_twin
from . import _fullrun
from ._fullrun import supports  # noqa: F401  (the kernel's config rule, read here too)

# Kernel iterations launched (one frame + one OLA launch each) by the whole
# run, and by the raw per-iteration dispatch; and of both, those whose frame
# launch took the many-wave plan (_fullrun.frame_plan).  KERNEL counts them
# in this module's namespace.
launches = 0
iteration_launches = 0
many_wave_launches = 0


KERNEL = _fullrun.Kernel("ADMM", "specinv_admm_iteration", admm_twin, globals())
fused_admm_run = KERNEL.run
fused_admm_iteration = KERNEL.iteration
fused_admm_run_reference = KERNEL.run_reference
fused_admm_iteration_reference = KERNEL.iteration_reference
