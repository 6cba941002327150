"""Distances that the checks share."""
from __future__ import annotations

import math

import torch

from ..core import percentile


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float64 (complex128)."""
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def rel(a: torch.Tensor, b: torch.Tensor) -> list:
    """Per row of the leading axis: ``||a - b|| / ||b||`` in float64
    (complex as pairs of reals); 0 where both are zero."""
    a, b = wide(a), wide(b)
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    num = (a - b).flatten(1).norm(dim=1)
    den = b.flatten(1).norm(dim=1)
    out = torch.where(den > 0, num / den.clamp_min(1e-300),
                      torch.where(num > 0, torch.full_like(num, float("inf")), num))
    return out.tolist()


def worst(values: list, q: float = 100) -> float:
    """The ``q``-th percentile of ``values`` (100: the largest); infinite
    where there is none or one is not a number, so that it fails."""
    if not values or any(math.isnan(v) for v in values):
        return math.inf
    return max(values) if q == 100 else percentile(values, q)
