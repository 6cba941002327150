"""One RTISI-LA output-frame step of every stream.

Per stream and refinement (``max_iter`` of them): the overlap-add of the
``nk + la + 1`` committed and in-flight frames through the synthesis
window (``2 n_fft`` each), the analysis window of the ``la + 1`` frames
(``n_fft`` each), a forward and an inverse real FFT of each, per bin the
momentum (4) and the projection (7); per step the emitted samples' window,
sum and envelope (``2 n_fft + hop``).  Bytes per step: one magnitude frame
read and ``hop`` samples written per stream, float32.  The streams are a
cell's ``streams``, or the clips of an offline call (``batch``).
"""
from __future__ import annotations

from ._peaks import least_seconds as _least
from ._peaks import rfft_flops

FLOPS_PER_BIN = 11


def streams(workload: dict) -> int:
    return workload["streams"] if "streams" in workload else workload["batch"]


def flops(config: dict, workload: dict) -> float:
    n, hop = config["n_fft"], config["hop_length"]
    la, iters = config["call"]["look_ahead"], config["call"]["max_iter"]
    frames, kept, bins = la + 1, (n - 1) // hop, n // 2 + 1
    refine = (kept + frames) * 2 * n + frames * (n + 2 * rfft_flops(n) + FLOPS_PER_BIN * bins)
    return streams(workload) * (iters * refine + 2 * n + hop)


def step_bytes(config: dict, workload: dict) -> float:
    return 4 * streams(workload) * (config["n_fft"] // 2 + 1 + config["hop_length"])


def least_seconds(config: dict, workload: dict) -> float:
    return _least(flops(config, workload), step_bytes(config, workload))
