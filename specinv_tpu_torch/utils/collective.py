"""Sums over the ranks of named mesh axes, for the stop rule.

``loss_psum_axes`` names axes of a mesh (``parallel/mesh.py``).  Under
``shard_map`` the JAX package resolves an axis name against the mapped
mesh; here the caller binds its mesh while an entry point runs
(:func:`bound`; ``parallel.batched`` does) and :func:`axis_sum` resolves
names against it.  A bound mesh is any object whose ``group(axis)`` gives
the process group of this rank's line along ``axis`` (None: one rank).

Transport: gloo's collectives and point-to-point operations take CPU
tensors, so on a gloo group a CUDA tensor passes through host memory
(:func:`staged`), which one card shared by several ranks needs (NCCL refuses
two ranks on one GPU).  On an NCCL group tensors stay on the card.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch
import torch.distributed as dist

_BOUND: contextvars.ContextVar = contextvars.ContextVar("specinv_mesh", default=None)


@contextlib.contextmanager
def bound(mesh):
    """Bind ``mesh`` while the block runs, so that mesh axis names
    (``loss_psum_axes``) resolve against it."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` passes through host memory on ``group``: a CUDA tensor
    on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_sum(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``t`` summed over each group in turn (None groups are skipped)."""
    for g in groups:
        if g is None:
            continue
        host = staged(t, g)
        buf = t.cpu() if host else t.clone()
        dist.all_reduce(buf, group=g)
        t = buf.to(t.device) if host else buf
    return t


def axis_sum(axes):
    """A function summing a tensor over the ranks of the bound mesh's
    ``axes``; raises outside a bound mesh or for an unknown axis."""
    mesh = _BOUND.get()
    if mesh is None:
        raise ValueError(
            f"mesh axes {tuple(axes)!r} need a bound mesh: pass loss_psum_axes "
            "through parallel.batched")
    groups = [mesh.group(a) for a in axes]

    def reduce(t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, groups)

    return reduce
