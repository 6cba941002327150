"""The direct DFT as matrix products in bf16-split precision schemes (plain
PyTorch; no kernel).

Counterpart of the plain parts of ``specinv_tpu/ops/pallas/gl_fused.py``:
the DFT tables (``_dft_tables``), the bf16 hi/lo split (``_split_bf16``),
the product schemes (``_dot3`` / ``_dot3_pre``, ``needs_lo``,
``split_schemes``), and the precision rule of
``specinv_tpu/ops/fourier.check_precision``.  ``ops/twins`` and the kernel
wrappers under ``ops/cuda`` both import it.

The schemes, with ``a`` the data operand and ``b`` the table, ``hi =
bf16(x)`` and ``lo = bf16(x - hi)`` (round to nearest):

==========  ====================================  =====================
name        product                               JAX ``precision``
==========  ====================================  =====================
'default'   ah @ bh                               ``DEFAULT``
'high'      (ah @ bh + ah @ bl) + al @ bh         ``HIGH`` (the default)
'bf16x2'    ah @ bh + ah @ bl                     ``'bf16x2'``
'bf16x2t'   ah @ bh + al @ bh                     ``'bf16x2t'``
'highest'   a @ b in the input's precision        ``HIGHEST``
==========  ====================================  =====================

A product of two bf16 values is exact in float32, so the plain version's
float32 product of the upcast halves computes the tensor-core product's
function; only the order of the sums differs.  With float64 inputs the
same splits are summed in float64 (the anchor the kernels' limits rest on).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import fourier

# The order is the kernels' scheme codes (csrc/dft_iter.cuh ``Scheme``).
SCHEMES = ("default", "high", "highest", "bf16x2", "bf16x2t")


@functools.lru_cache(maxsize=16)
def dft_tables(n_fft: int, normalized: bool):
    """``(cos, sin, w)`` float32 numpy arrays: the (n_fft, F) cos/sin tables
    times the forward scale and the (F,) Hermitian fold weights times
    ``iscale / fscale``, F = n_fft // 2 + 1.

    Built in float64 and cast as ``gl_fused._dft_tables`` builds them, whose
    first F columns they equal; the port keeps no padding columns.
    """
    num_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(num_freqs)[None, :]
    theta = 2.0 * np.pi * n * k / n_fft
    fscale = 1.0 / math.sqrt(n_fft) if normalized else 1.0
    cos = np.cos(theta) * fscale
    sin = np.sin(theta) * fscale
    w = np.full((num_freqs,), 2.0)
    w[0] = 1.0
    w[num_freqs - 1] = 1.0
    iscale = 1.0 / math.sqrt(n_fft) if normalized else 1.0 / n_fft
    # the forward carries fscale; the inverse needs w * iscale / fscale on top
    w = w * (iscale / fscale)
    out = tuple(a.astype(np.float32) for a in (cos, sin, w))
    for a in out:
        a.setflags(write=False)
    return out


@functools.lru_cache(maxsize=16)
def table_tensors(n_fft: int, normalized: bool, device: torch.device, dtype: torch.dtype):
    """:func:`dft_tables` as tensors of ``dtype`` on ``device`` (the float32
    values, widened for float64), cached so the plain version makes no host
    copy per call."""
    return tuple(torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)
                 for a in dft_tables(n_fft, normalized))


def split_bf16(x: torch.Tensor):
    """``(hi, lo)`` bf16 halves of ``x``: ``x ~= hi + lo`` to about 16 bits."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


def needs_lo(scheme: str) -> bool:
    """Whether the scheme reads the data operand's low half."""
    return scheme in ("high", "bf16x2t")


def split_schemes(precision):
    """A precision (one scheme, or a ``(forward, inverse)`` pair) ->
    ``(forward, inverse)``."""
    if isinstance(precision, tuple):
        return precision
    return precision, precision


def scheme_matmul(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """``a @ b`` in the scheme (the plain ``_dot3``): every half is widened
    back to ``a``'s type and the passes are added in JAX's order."""
    if scheme == "highest":
        return a @ b
    dt = a.dtype

    def up(t):
        return t.to(dt)

    if scheme == "default":
        return up(a.to(torch.bfloat16)) @ up(b.to(torch.bfloat16))
    ah, al = split_bf16(a) if needs_lo(scheme) else (a.to(torch.bfloat16), None)
    ah = up(ah)
    if scheme == "bf16x2t":
        bh = up(b.to(torch.bfloat16))
        return ah @ bh + up(al) @ bh
    bh, bl = (up(t) for t in split_bf16(b))
    if scheme == "bf16x2":
        return ah @ bh + ah @ bl
    return ah @ bh + ah @ bl + up(al) @ bh


def _scheme(p) -> str | None:
    name = p.lower() if isinstance(p, str) else None
    return name if name in SCHEMES else None


def check_precision(precision, backend: str):
    """The JAX ``fourier.check_precision`` rule in the port.

    On ``'dft'`` every scheme name is taken (any case), and a ``(forward,
    inverse)`` pair of them; None is :func:`fourier.default_precision`.
    Returns the canonical lower-case name or pair.  The ``'kernel'`` and
    ``'fft'`` backends compute in full float32 (or the input's precision):
    they take None, ``'high'`` and ``'highest'`` (any case) and return them
    unchanged, and raise on anything else, scheme strings and pairs
    included.  ``'fft'`` also takes ``'default'``, as JAX's XLA backends do,
    and ignores it as ``jnp.fft`` does; ``'kernel'`` refuses it, since JAX's
    ``pallas4`` computes it as one bf16 pass, which the float32 kernel
    cannot match."""
    if backend == "dft":
        if precision is None:
            return fourier.default_precision()
        if isinstance(precision, tuple) and len(precision) == 2:
            pair = tuple(_scheme(p) for p in precision)
            if None not in pair:
                return pair
        elif _scheme(precision) is not None:
            return _scheme(precision)
        raise ValueError(
            f"precision {precision!r} is not valid for backend 'dft': expected one "
            f"of {SCHEMES} or a (forward, inverse) pair of them")
    float32_tiers = ("default", "high", "highest") if backend == "fft" else ("high", "highest")
    if precision is None or _scheme(precision) in float32_tiers:
        return precision
    if backend == "kernel" and _scheme(precision) == "default":
        raise ValueError(
            "precision 'default' is not supported on backend 'kernel': JAX's "
            "pallas4 computes it as a single bf16 pass, which the float32 kernel "
            "cannot match (pass None, 'high' or 'highest', or use backend='dft')"
        )
    raise ValueError(
        f"precision {precision!r} is not supported on backend {backend!r}: it "
        f"computes in full float32 (pass None or one of {float32_tiers}); bf16 "
        "schemes and (forward, inverse) pairs are for backend='dft'"
    )
