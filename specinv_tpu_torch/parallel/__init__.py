"""Data- and sequence-parallel inversion over ``torch.distributed``
(counterpart of ``specinv_tpu.parallel``)."""
from .batch import batched
from .mesh import batch_sharding, make_mesh, shard_batch
from .seq import admm_seq, griffin_lim_seq

__all__ = [
    "batched",
    "batch_sharding",
    "make_mesh",
    "shard_batch",
    "griffin_lim_seq",
    "admm_seq",
]
