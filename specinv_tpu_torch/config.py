"""STFT configuration & canonicalization (numpy only).

Counterpart of ``specinv_tpu/config.py``: the reference's ``**stft_kwargs``
passthrough to ``torch.stft`` captured in a hashable, frozen
:class:`STFTConfig`, with the same default-inference rules:

  * ``onesided`` inferred from window complexity
  * ``n_fft = (F-1)*2`` if onesided else ``F``
  * ``win_length = n_fft`` when unset
  * ``hop_length = n_fft // 4`` when unset
  * rectangular window default
  * window zero-padded symmetrically up to ``n_fft``
  * ``return_complex`` accepted and ignored (spectra are always complex)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

# torch.nn.functional.pad already speaks the torch.stft pad_mode vocabulary.
PAD_MODES = ("reflect", "constant", "replicate", "circular")

STFT_KWARG_NAMES = (
    "win_length",
    "window",
    "hop_length",
    "center",
    "pad_mode",
    "normalized",
    "onesided",
    "return_complex",
)


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """Fully-canonicalized STFT parameters.

    The window array is carried beside the config; ``win_length`` is always
    ``n_fft`` after canonicalization (the window has been zero-padded).
    """

    n_fft: int
    hop_length: int
    center: bool = True
    pad_mode: str = "reflect"
    normalized: bool = False
    onesided: bool = True

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1 if self.onesided else self.n_fft

    @property
    def fft_norm(self) -> Optional[str]:
        return "ortho" if self.normalized else None

    @property
    def pad_amount(self) -> int:
        """Samples of center padding on each side."""
        return self.n_fft // 2 if self.center else 0

    @property
    def torch_pad_mode(self) -> str:
        """Mode name for ``torch.nn.functional.pad``."""
        return self.pad_mode

    def num_frames(self, num_samples: int) -> int:
        padded = num_samples + 2 * self.pad_amount
        return 1 + (padded - self.n_fft) // self.hop_length

    def output_length(self, num_frames: int) -> int:
        """ISTFT output length: full OLA length minus the symmetric center
        trim (the reference's conv-transpose semantics, not torch.istft's)."""
        full = (num_frames - 1) * self.hop_length + self.n_fft
        return full - 2 * self.pad_amount


def as_numpy_window(window: Any) -> np.ndarray:
    """Accept numpy / torch / list windows uniformly (a window on the card
    is copied to the host: one host sync)."""
    if hasattr(window, "detach"):
        from .utils.profiling import host_sync

        with host_sync(window):
            window = window.detach().cpu().numpy()
    return np.asarray(window)


def canonicalize(
    num_freq_bins: int,
    real_dtype: Any,
    win_length: Optional[int] = None,
    window: Any = None,
    hop_length: Optional[int] = None,
    center: bool = True,
    pad_mode: str = "reflect",
    normalized: bool = False,
    onesided: Optional[bool] = None,
    return_complex: Optional[bool] = None,
    **_ignored: Any,
):
    """Canonicalize torch.stft-style kwargs given the spectrogram's bin count.

    Returns ``(config, window)`` where ``window`` is a dense float (or
    complex) numpy array of length ``n_fft``.
    """
    del return_complex
    if pad_mode not in PAD_MODES:
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")

    if window is not None:
        window = as_numpy_window(window)

    if onesided is None:
        onesided = not (window is not None and np.iscomplexobj(window))

    n_fft = (num_freq_bins - 1) * 2 if onesided else num_freq_bins

    if not win_length:
        win_length = n_fft
    if not hop_length:
        hop_length = n_fft // 4

    if window is None:
        window = np.ones(win_length, dtype=np.dtype(real_dtype))

    if n_fft < win_length:
        raise ValueError(f"n_fft ({n_fft}) must be >= win_length ({win_length})")
    if n_fft > win_length:
        lpad = (n_fft - win_length) // 2
        rpad = (n_fft - win_length + 1) // 2
        window = np.pad(window, (lpad, rpad))

    cfg = STFTConfig(
        n_fft=n_fft,
        hop_length=hop_length,
        center=center,
        pad_mode=pad_mode,
        normalized=normalized,
        onesided=onesided,
    )
    return cfg, window
