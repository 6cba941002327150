"""The ``(data, seq)`` mesh of ranks over ``torch.distributed``.

Counterpart of ``specinv_tpu/parallel/mesh.py``.  The JAX package lays a
``jax.sharding.Mesh`` over its devices and runs one program over all of
them; here every rank of the default process group runs its own program,
and a :class:`Mesh` tells a rank where it sits: its ``(data, seq)``
coordinate, one process group per axis (the ranks that share its other
coordinate), and its device.  ``seq`` is the innermost axis, as in JAX, so
neighbouring shards of a clip are neighbouring ranks.

The mesh's axes are what ``loss_psum_axes`` names: ``parallel.batched``
binds its mesh (``utils.collective.bound``) while the wrapped entry point
runs, and the stop rule resolves the names against it.

Transport (``utils.collective.staged``): on a gloo group a CUDA tensor
passes through host memory, which one card shared by several ranks needs
(NCCL refuses two ranks on one GPU); on an NCCL group tensors stay on the
card.  Either way the kernels and every other operation run on the rank's
device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.collective import all_gather  # noqa: F401  (the layer's gather, differentiable)

AXES = ("data", "seq")


def _world() -> tuple[int, int]:
    """``(world size, rank)`` of the default process group, or ``(1, 0)``
    when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """This rank's view of a ``(data, seq)`` grid of ranks.

    ``ranks[i, j]`` is the global rank at data index ``i`` and seq index
    ``j``; ``coord`` is this rank's ``(i, j)``, or None for a rank the mesh
    leaves out (a world larger than ``data * seq``).
    """

    def __init__(self, ranks: np.ndarray, rank: int, groups: Dict[str, object],
                 device: torch.device):
        self.ranks = ranks
        self.rank = rank
        self.device = device
        self._groups = groups
        hit = np.argwhere(ranks == rank)
        self.coord = tuple(int(c) for c in hit[0]) if len(hit) else None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.ranks.shape))

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.coord is None:
            raise ValueError(f"rank {self.rank} is not in this {self._dims()} mesh")
        return self.coord[_axis(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``: None when
        the axis has one rank (no communication)."""
        _axis(axis)
        return self._groups.get(axis)

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` on this rank's line."""
        self.index(axis)  # raises for a rank the mesh leaves out
        i, j = self.coord
        return int(self.ranks[index, j] if axis == "data" else self.ranks[i, index])

    def _dims(self) -> str:
        return "x".join(str(d) for d in self.ranks.shape)


def _axis(axis: str) -> int:
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; the mesh's axes are {AXES}")
    return AXES.index(axis)


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise ValueError(
            "no CUDA card: the mesh runs on the card; pass device='cpu' to run it on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(data: Optional[int] = None, seq: int = 1, device=None) -> Mesh:
    """Build a ``(data, seq)`` mesh over the default process group's ranks.

    ``data`` defaults to ``world_size // seq``; the first ``data * seq``
    ranks form the mesh, ``seq`` innermost.  Every rank of the default
    group must call it (it creates one process group per line of each axis
    with more than one rank).  With no process group initialised the world
    is one rank and ``make_mesh()`` is the 1x1 mesh.  ``device`` defaults
    to ``cuda:{rank % device_count}``; without a card it must be given
    (``'cpu'``).
    """
    n, rank = _world()
    if data is None:
        if n % seq:
            raise ValueError(f"{n} ranks not divisible by seq={seq}")
        data = n // seq
    if data * seq > n:
        raise ValueError(f"mesh {data}x{seq} needs {data * seq} ranks, have {n}")
    ranks = np.arange(data * seq).reshape(data, seq)
    groups = {}
    # every rank creates every group, in the same order, as new_group needs
    for axis, lines in (("data", ranks.T), ("seq", ranks)):
        if lines.shape[1] > 1:
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = g
    dev = _default_device(rank) if device is None else torch.device(device)
    return Mesh(ranks, rank, groups, dev)


def batch_sharding(mesh: Mesh, *positional, batch: Optional[int] = None,
                   axis_name: str = "data") -> slice:
    """This rank's rows of a batch of ``batch`` clips split over
    ``axis_name`` (the JAX ``NamedSharding`` of the batch axis, seen from
    one rank).  Called as ``batch_sharding(mesh, *, batch, axis_name)``:
    JAX's ``batch_sharding(mesh, ndim, axis_name)`` takes an array rank and
    returns a sharding, so a positional second argument raises rather than
    being read as a batch size."""
    if positional or batch is None:
        raise TypeError(
            "batch_sharding(mesh, *, batch, axis_name='data') takes the batch by keyword: "
            "JAX's second argument is ndim and returns a NamedSharding, the port's "
            "returns this rank's rows of `batch` clips; pass batch=")
    n = mesh.shape[axis_name]
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} ranks of {axis_name!r}")
    b = batch // n
    i = mesh.index(axis_name)
    return slice(i * b, (i + 1) * b)


def shard_batch(x, mesh: Mesh, axis_name: str = "data") -> torch.Tensor:
    """This rank's slice of ``x``'s batch axis, on the mesh's device."""
    x = torch.as_tensor(x)
    return x[batch_sharding(mesh, batch=x.shape[0], axis_name=axis_name)].to(mesh.device)
