"""``griffin_lim_seq`` / ``admm_seq`` of the port over 4 gloo CPU processes.

One spawn (``tests/torch_dist_worker.py``) runs every case on a 1x4 mesh,
or a 2x2 mesh with ``shard_batch_axis``; rank 0's waveforms are held against
the JAX functions on a CPU mesh of the same shape and against the port's
unsharded call, at the bands of ``test_torch_seq.py``: every pad mode of
both algorithms, the tol=3e-3 stop-iteration regression, data x seq with
and without early stopping, and the too-many-shards error.  The gradient
cases: both algorithms in every pad mode (circular exercises the edge
pair's reverse exchange), data x seq with ``shard_batch_axis`` (fft and
kernel), and ADMM with a shard that holds only padding (``valid_t`` 0),
whose kernel gradient is also held against the fft path's.
"""
import numpy as np
import pytest

from . import torch_dist_worker as worker
from .test_torch_seq import GRAD_F32_BAND, check_case, check_close


@pytest.fixture(scope="module")
def seq4(tmp_path_factory):
    return worker.run_job("seq", 4, tmp_path_factory.mktemp("seq4"))


@pytest.mark.parametrize("name", list(worker.SEQ_JOBS[4]))
def test_seq_four_ranks_match_jax(seq4, name):
    check_case(seq4, name, worker.SEQ_JOBS[4][name], 4)


def test_padding_shard_kernel_gradient_matches_fft(seq4):
    """The shard of padding rows stays inert in the replayed twin (its
    valid_t of 0 from the forward pass): the kernel's gradient against the
    fft path's at JAX's band (read 1.5e-6)."""
    out = seq4["admm_grad_padding_shard_kernel"]
    assert np.isfinite(out).all()
    check_close(out, seq4["admm_grad_padding_shard_fft"], GRAD_F32_BAND)
