"""The parallel layer's collectives: the stop rule's sums over named mesh
axes, and the three differentiable collectives of the data and sequence
paths.

``loss_psum_axes`` names axes of a mesh (``parallel/mesh.py``).  Under
``shard_map`` the JAX package resolves an axis name against the mapped
mesh; here the caller binds its mesh while an entry point runs
(:func:`bound`; ``parallel.batched`` does) and :func:`axis_sum` resolves
names against it.  A bound mesh is any object whose ``group(axis)`` gives
the process group of this rank's line along ``axis`` (None: one rank).

Gradients (the counterparts of ``ppermute``, ``all_gather`` and a
replicated ``shard_map`` input under ``jax.grad``): :func:`shift` is the
halo exchange, whose backward is the reverse exchange; :func:`all_gather`
keeps this rank's slice of the cotangent; :func:`replicated` is the
identity whose backward sums the cotangent over the ranks that share the
input.  Every rank returns the whole output and computes the same loss of
it, so the cotangent of a gathered output is the same on every rank (not
summed), and every rank ends with the whole gradient of a replicated
input.  Every rank must call ``backward`` on that same loss: the backward
passes exchange with each other, in the same order on every rank.

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
    """``t`` summed over each group in turn (None groups are skipped); not
    differentiable."""
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


def _exchange(t: torch.Tensor, group, dst, src) -> torch.Tensor:
    """Send ``t`` to global rank ``dst`` and receive a tensor shaped like it
    from ``src`` (either may be None); zeros where nothing arrives."""
    if dst is None and src is None:
        return torch.zeros_like(t)
    host = staged(t, group)
    send = t.contiguous().cpu() if host else t.contiguous()
    recv = torch.zeros_like(send)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send, dst, group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)


class _Shift(torch.autograd.Function):
    """The exchange; backward: the cotangent of what arrived goes back to
    ``src``, and the cotangent of what left arrives from ``dst``."""

    @staticmethod
    def forward(ctx, t, group, dst, src):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        return _exchange(t, group, dst, src)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.src, ctx.dst), None, None, None


def shift(t: torch.Tensor, group, dst, src) -> torch.Tensor:
    """Send ``t`` to global rank ``dst`` of ``group`` and receive a tensor
    shaped like it from ``src`` (either may be None: zeros arrive), the
    counterpart of ``lax.ppermute``; differentiable.  Every rank of the
    group calls it, an edge rank too, so that the backward exchanges pair
    up in the same order on every rank."""
    return _Shift.apply(t, group, dst, src)


class _AllGather(torch.autograd.Function):
    """The gather; backward: this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, t.shape[dim]
        host = staged(t, group)
        src = t.contiguous().cpu() if host else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size), None, None


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim`` in rank order (``t``
    itself for a None group); differentiable: the backward keeps this
    rank's slice of the cotangent, not summed over the ranks, because every
    rank computes the same loss of the whole output."""
    if group is None:
        return t
    return _AllGather.apply(t, group, dim)


class _Replicated(torch.autograd.Function):
    """The identity; backward: the cotangent summed over the groups."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.groups), None


def replicated(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``t``, an input that every rank of ``groups`` holds whole and each
    differentiates only through its own part of: the backward sums the
    cotangent over the groups (None groups are skipped), so every rank
    holds the whole gradient."""
    groups = [g for g in groups if g is not None]
    return _Replicated.apply(t, groups) if groups else t
