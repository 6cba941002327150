"""specinv_tpu_torch — spectrogram inversion on PyTorch and CUDA (Hopper).

The port of ``specinv_tpu`` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100.  This package imports neither
JAX nor ``specinv_tpu``; it exports what the JAX package exports: Griffin-Lim
(SPSI phase seed, the whole-run Griffin-Lim kernel, the direct-DFT
iteration kernel of ``backend='dft'`` with the JAX precision tiers, and the
``torch.fft`` path), ADMM (the whole-run and direct-DFT ADMM kernels and the
literal ``torch.fft`` chain), L-BFGS over any differentiable transform,
RTISI-LA offline and streaming (the multi-step RTISI kernel and the literal
``torch.fft`` step), the mel frontend and its inversion, the STFT pair and
the metrics.  The parallel layer lives in ``specinv_tpu_torch.parallel``
(``make_mesh``, ``batched``, ``griffin_lim_seq``, ``admm_seq``), audio files
in ``specinv_tpu_torch.io``, checkpoints, guards and profiling in
``specinv_tpu_torch.utils``, and ``python -m specinv_tpu_torch`` is the demo
command line, as in the JAX package.
"""
name = "specinv_tpu_torch"
__version__ = "0.1.0"

from .config import STFTConfig, canonicalize  # noqa: F401
from .metrics import sc, ser, snr, spectral_convergence  # noqa: F401
from .models import (  # noqa: F401
    ADMM,
    L_BFGS,
    RTISI_LA,
    RTISIStreamer,
    admm,
    griffin_lim,
    l_bfgs,
    phase_init,
    rtisi_la,
)
from .ops.mel import (  # noqa: F401
    log_mel_transform,
    mel_filterbank,
    mel_to_audio,
    mel_to_linear,
)
from .transforms import istft, stft  # noqa: F401

__all__ = [
    "ADMM",
    "admm",
    "L_BFGS",
    "l_bfgs",
    "RTISI_LA",
    "RTISIStreamer",
    "rtisi_la",
    "griffin_lim",
    "phase_init",
    "sc",
    "snr",
    "ser",
    "spectral_convergence",
    "STFTConfig",
    "canonicalize",
    "stft",
    "istft",
    "log_mel_transform",
    "mel_filterbank",
    "mel_to_audio",
    "mel_to_linear",
]
