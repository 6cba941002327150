"""What the RTISI-LA checks share: the control's rounding and the check of
the inputs that a launch of the program's RTISI-LA kernel starts from.

Both checks read the arguments of
``specinv_tpu_torch.ops.cuda.rtisi_fused.fused_rtisi_steps(keeped, update,
pre, target, windows, lr, cfg, max_iter) -> (committed, keeped, update,
pre)``, taken with ``inputs.Tap``: the state ``(B, nk, n)``, ``(B, la + 1,
n)``, ``(B, la + 1, F)`` complex, the target rows ``(B, k + la, F)``, the
windows (``window``, ``first``, ``rest``, ``synth``) and the parameters.
"""
from __future__ import annotations

import math

import torch

from ..reference import rtisi_la as reference
from ..reference._signal import bf16_keep
from ._distance import rel, wide


def low(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 (complex64), rounded to bfloat16: the control's type."""
    return bf16_keep(t.to(torch.complex64 if t.is_complex() else torch.float32))


def start_dists(launch, first: torch.Tensor, rows: torch.Tensor, la: int, hop: int, it: int,
                alpha: float, w64: torch.Tensor, control: bool) -> list:
    """Per stream: the worst distance of a first launch's state, target rows,
    windows and parameters from the reference's start: the initial state
    from the first magnitude frame ``first (B, F)`` and the target ``rows
    (B, k + la, F)`` that the launch should read."""
    if launch is None:  # the program launched no RTISI step
        return [math.inf] * first.shape[0]
    keeped, update, pre, target, windows, lr, _cfg, max_iter = launch
    expected = reference.initial_state(wide(first), la, hop)
    if control:
        keeped, update, pre = reference.initial_state(low(first), la, hop, bf16_keep)
    # keeped and pre start at zero: measure them against the seed's size
    seed = wide(expected[1]).flatten(1).norm(dim=1)
    zeros = [float(v) for v in (torch.view_as_real(wide(pre)).flatten(1).norm(dim=1)
                                + wide(keeped).flatten(1).norm(dim=1)) / seed]
    synth = w64 * hop / torch.sum(w64 * w64)
    common = max(rel(torch.stack([windows.window, windows.first, windows.rest]),
                     w64.expand(3, -1))
                 + rel(windows.synth[None], synth[None])
                 + [abs(lr - alpha / (1 + alpha)) / (alpha / (1 + alpha)),
                    0.0 if max_iter == it else math.inf])
    return [max(common, *per) for per in zip(rel(update, expected[1]), zeros,
                                              rel(target, rows))]
