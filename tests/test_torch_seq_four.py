"""``griffin_lim_seq`` / ``admm_seq`` of the port over 4 gloo CPU processes.

One spawn (``tests/torch_dist_worker.py``) runs every case on a 1x4 mesh,
or a 2x2 mesh with ``shard_batch_axis``; rank 0's waveforms are held against
the JAX functions on a CPU mesh of the same shape and against the port's
unsharded call, at the bands of ``test_torch_seq.py``: every pad mode of
both algorithms, the tol=3e-3 stop-iteration regression, data x seq with
and without early stopping, and the too-many-shards error.
"""
import pytest

from . import torch_dist_worker as worker
from .test_torch_seq import check_case


@pytest.fixture(scope="module")
def seq4(tmp_path_factory):
    return worker.run_job("seq", 4, tmp_path_factory.mktemp("seq4"))


@pytest.mark.parametrize("name", list(worker.SEQ_JOBS[4]))
def test_seq_four_ranks_match_jax(seq4, name):
    check_case(seq4, name, worker.SEQ_JOBS[4][name], 4)
