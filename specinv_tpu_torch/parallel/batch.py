"""Batch (data-parallel) inversion over the ranks of a mesh.

Counterpart of ``specinv_tpu/parallel/batch.py``.  Clips are independent in
every algorithm, so data parallelism is placement: each rank of the mesh's
``data`` axis inverts its slice of the batch with the whole entry point
(the hand-written kernels included), and the waveforms are all-gathered, so
every rank returns the whole batch.  Fixed-iteration runs (``tol=0``) give
each clip what the unsharded call gives it.  The input enters through
``utils.collective.replicated`` and leaves through its differentiable
``all_gather``, so a gradient flows as through JAX's ``shard_map``.

The JAX package has two lowerings; here both are per-rank runs:

* default: the stop rule is per rank (each rank's mean loss drives its own
  stop), as JAX's ``shard_map`` lowering; ``global_stop=True`` sums the
  stop loss over the axis (``loss_psum_axes=(axis_name,)``), the unsharded
  stop rule, keeping the kernels.
* ``gspmd=True``: JAX lets GSPMD partition the XLA ops, which gives the
  global stop rule and no custom kernel (it pins ``backend='matmul'`` on an
  accelerator).  Here that is ``loss_psum_axes=(axis_name,)`` for an entry
  point that takes it, and ``backend='fft'`` set by default on the card.
"""
from __future__ import annotations

import inspect
from typing import Callable

import numpy as np
import torch

from ..utils.collective import all_gather, bound, replicated
from . import mesh as mesh_mod
from .mesh import Mesh


def _takes(fn: Callable, name: str):
    """Whether ``fn`` names parameter ``name``; None when it has no
    signature."""
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins and partials without one
        return None


def batched(
    fn: Callable, mesh: Mesh, axis_name: str = "data", gspmd: bool = False,
    global_stop: bool = False,
) -> Callable:
    """Wrap a public algorithm entry point to run batch-sharded over ``mesh``.

    Example (every rank of the mesh runs the same lines)::

        gl = batched(specinv_tpu_torch.griffin_lim, mesh)
        waves = gl(specs_bft, max_iter=100, tol=0.0, verbose=False)

    An uneven batch is padded with zero-magnitude clips, inert under every
    algorithm, and trimmed after.  Early stopping (``tol > 0``) is per rank
    unless ``global_stop`` (or ``gspmd``) is set; ``global_stop`` needs an
    entry point that takes ``loss_psum_axes`` (``griffin_lim``, ``ADMM``).

    Differentiable, as JAX's ``shard_map`` lowering: every rank must call
    ``backward`` on the same loss of the whole output, and every rank then
    holds the whole gradient of ``spec``.
    """
    if global_stop and not gspmd and _takes(fn, "loss_psum_axes") is False:
        raise ValueError(
            f"global_stop=True needs an entry point that accepts loss_psum_axes "
            f"(griffin_lim/ADMM); {getattr(fn, '__name__', fn)!r} does not — its "
            f"stop rule (if any) is per-shard"
        )

    def wrapper(spec, *args, **kwargs):
        if (global_stop or gspmd) and _takes(fn, "loss_psum_axes") is not False:
            kwargs.setdefault("loss_psum_axes", (axis_name,))
        if gspmd and mesh.device.type == "cuda":
            kwargs.setdefault("backend", "fft")
        if isinstance(spec, torch.Tensor):
            spec = spec.to(mesh.device)
        else:
            spec = torch.as_tensor(np.asarray(spec), device=mesh.device)
        if spec.ndim != 3:
            raise ValueError(
                f"batched inversion needs a (B, F, T) spectrogram; got rank {spec.ndim}")
        n, B = mesh.shape[axis_name], spec.shape[0]
        pad = (-B) % n
        if pad:
            spec = torch.cat([spec, spec.new_zeros((pad, *spec.shape[1:]))], dim=0)
        group = mesh.group(axis_name)
        rows = mesh_mod.batch_sharding(mesh, batch=spec.shape[0], axis_name=axis_name)
        local = replicated(spec, [group])[rows]
        with bound(mesh):
            out = fn(local, *args, **kwargs)
        out = all_gather(out, group, dim=0)
        return out[:B] if pad else out

    return wrapper
