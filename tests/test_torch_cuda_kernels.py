"""The port's hand-written CUDA kernels on the card.

Every test here is marked ``cuda`` and skips without a CUDA card (the CPU
tests hold the kernels' plain versions to the JAX package instead).  On a
machine with an NVIDIA GPU and nvcc, from the root of a checkout:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the port and the
GPU machine do without.)  chip_smoke.py runs the same kernels at the main
paths' shapes.
"""
import numpy as np
import pytest
import torch

from specinv_tpu_torch.config import canonicalize
from specinv_tpu_torch.models import _kernel_driver as kd
from specinv_tpu_torch.models.phase_init import phase_init_tm
from specinv_tpu_torch.ops import stft as stft_ops
from specinv_tpu_torch.ops.cuda import admm_fullrun, gl_fullrun
from specinv_tpu_torch.ops.framing import pad_center
from specinv_tpu_torch.utils.corpus import make_speech_like

pytestmark = pytest.mark.cuda

# (module, kernel wrapper, scalar, x limit relative to the max; the limits
# of chip_smoke.py)
KERNELS = {
    "gl": (gl_fullrun, "fused_gl_run", 0.99 / 1.99, 5e-5),
    "admm": (admm_fullrun, "fused_admm_run", 0.1, 2e-3),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _state(dev, n_fft=512, hop=128):
    """A 2-clip speech-like starting state (SPSI seed, x0 = istft(seed))."""
    win_np = torch.hann_window(n_fft).numpy()
    cfg, w = canonicalize(n_fft // 2 + 1, np.float32, window=win_np, hop_length=hop)
    clips = np.stack([make_speech_like(7800, seed=s) for s in range(2)]).astype(np.float32)
    win = torch.from_numpy(w).to(dev)
    mag = stft_ops.stft(torch.from_numpy(clips).to(dev), cfg, win).abs().contiguous()
    seed = phase_init_tm(mag, cfg).to(torch.complex64)
    T = mag.shape[-2]
    x_pad = pad_center(stft_ops.istft(seed, cfg, win), cfg).contiguous()
    inv_env = kd.make_inv_env(cfg, win, T, kd.make_geometry(cfg, T))
    return cfg, (x_pad, seed, mag, win, inv_env)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_eval_iterations_round_like_the_others(dev, name):
    """An iteration that emits |S| or the eval sums computes the same state
    bitwise as one that does not, so an early-stopping run (segments with an
    eval iteration each) follows the tol=0 trajectory exactly."""
    mod, run, scalar, _ = KERNELS[name]
    fn = getattr(mod, run)
    cfg, (x0, s0, tgt, win, inv_env) = _state(dev)
    x20, s20 = fn(x0, s0, tgt, win, inv_env, scalar, cfg, 20, emit_state=True)
    x, s = x0, s0
    for _ in range(2):
        x, s, _mag, _stats = fn(x, s, tgt, win, inv_env, scalar, cfg, 10, emit_state=True,
                                with_mag=True, with_loss=True)
    torch.cuda.synchronize()
    assert torch.equal(x, x20) and torch.equal(s, s20)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_plain_version(dev, name):
    mod, run, scalar, x_limit = KERNELS[name]
    cfg, state = _state(dev)
    before = mod.launches
    x = getattr(mod, run)(*state, scalar, cfg, 5)
    ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, 5)
    torch.cuda.synchronize()
    assert mod.launches - before == 5
    assert float((x - ref).abs().max() / ref.abs().max()) <= x_limit
