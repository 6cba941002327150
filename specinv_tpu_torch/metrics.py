"""Quality metrics: spectral convergence, SNR, SER on torch tensors.

Counterpart of ``specinv_tpu/metrics.py`` (the reference's
``torch_specinv/metrics.py`` math), including the ``spectral_convergence``
alias and SNR's normalization of both sides by the *target* norm.
"""
from __future__ import annotations

import torch


def sc(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Spectral convergence in dB: ``20*log10(||X - Y||_F / ||Y||_F)``."""
    num = torch.linalg.vector_norm(input - target)
    den = torch.linalg.vector_norm(target)
    return 20 * (torch.log10(num) - torch.log10(den))


def snr(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``-10*log10 sum((x_i/||Y|| - y_i/||Y||)^2)``: both sides are
    normalized by the *target* norm, as in the reference."""
    norm = torch.linalg.vector_norm(target)
    return -10 * torch.log10(torch.sum((input / norm - target / norm) ** 2))


def ser(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``10*log10(sum x_i^2 / sum (x_i - y_i)^2)``."""
    return 10 * (
        torch.log10(torch.sum(input**2)) - torch.log10(torch.sum((input - target) ** 2))
    )


spectral_convergence = sc

METRIC_FNS = {"SC": sc, "SNR": snr, "SER": ser}


def get_metric(name: str):
    key = name.upper()
    if key not in METRIC_FNS:
        raise ValueError(f"unknown metric {name!r}; available: {list(METRIC_FNS)}")
    return METRIC_FNS[key]
