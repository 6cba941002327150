"""Optional numeric guards behind a debug switch.

Counterpart of ``specinv_tpu/utils/guards.py``.  The library replaces exact
zeros of the OLA envelope by 1 in its fast path (where the torch reference
would divide by zero); inside ``debug_checks()`` the checks planted in the
library (the zero-envelope check of ``ops.stft.istft``) raise
:class:`CheckError` instead::

    from specinv_tpu_torch.utils import guards

    with guards.debug_checks():
        y = guards.checked(st.griffin_lim)(mag, max_iter=100, verbose=False)

``checked(fn)`` also raises when ``fn``'s output holds a NaN or an infinity.
The JAX package functionalizes ``fn`` with ``checkify``, which finds a
non-finite value anywhere inside it; here the check reads the output.
Outside ``debug_checks()`` a planted check is not evaluated, so it adds no
device synchronisation.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree

from .profiling import host_sync

_ENABLED = False


class CheckError(RuntimeError):
    """A planted check or a finiteness check failed."""


def debug_checks_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def debug_checks():
    """Evaluate the library's planted checks within the context."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = True
    try:
        yield
    finally:
        _ENABLED = prev


def check(pred, msg: str, **fmt_kwargs) -> None:
    """A planted check: raise :class:`CheckError` with ``msg`` (formatted
    with ``fmt_kwargs``) when ``pred`` (a bool or a tensor) is false.  A
    no-op unless inside ``debug_checks()``: ``pred`` is not read then."""
    if not _ENABLED:
        return
    with host_sync(pred):
        ok = bool(pred)
    if not ok:
        raise CheckError(msg.format(**fmt_kwargs))


def checked(fn):
    """Wrap ``fn`` so that a NaN or an infinity in its output (any tensor
    leaf) raises :class:`CheckError`; the planted checks raise on their own
    inside ``debug_checks()``."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in pytree.tree_leaves(out):
            if isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex()):
                with host_sync(leaf):
                    finite = bool(torch.isfinite(leaf).all())
                if not finite:
                    raise CheckError(f"non-finite value in the output of "
                                     f"{getattr(fn, '__name__', fn)!r}")
        return out

    return wrapper
