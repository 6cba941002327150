"""One Griffin-Lim iteration of every clip of a call.

Per frame: a forward and an inverse real FFT of ``n_fft`` points, the
analysis and the synthesis window and the overlap-add (``3 n_fft``), the
envelope's multiply (``hop``).  Per bin: the magnitude (4: two products, a
sum, a root), the momentum (4), the projection (7: the magnitude again, a
division, a complex scale).  Bytes per call: the magnitudes and the window
read once, the waveforms written once, float32, spread over the call's
iterations.  ``plane_bytes`` is the traffic of one iteration's planes
(frames, spectrum state, target, signal), for information only.
"""
from __future__ import annotations

from ._peaks import least_seconds as _least
from ._peaks import rfft_flops

FLOPS_PER_BIN = 15


def shape(config: dict, workload: dict):
    n, hop = config["n_fft"], config["hop_length"]
    samples = round(config["clip_seconds"] * config["sample_rate"])
    frames = 1 + samples // hop  # centred framing
    return workload["batch"], frames, n, hop, n // 2 + 1


def flops(config: dict, workload: dict) -> float:
    clips, frames, n, hop, bins = shape(config, workload)
    return clips * frames * (2 * rfft_flops(n) + 3 * n + hop + FLOPS_PER_BIN * bins)


def call_bytes(config: dict, workload: dict) -> float:
    clips, frames, n, hop, bins = shape(config, workload)
    return 4 * (clips * frames * bins + n + clips * (frames - 1) * hop)


def least_seconds(config: dict, workload: dict) -> float:
    per_call = workload["units_per_call"]
    return _least(flops(config, workload), call_bytes(config, workload) / per_call)


def plane_bytes(config: dict, workload: dict) -> float:
    """One iteration's plane traffic if each plane crossed memory once:
    frames written and read, the complex state read and written, the
    target read, the signal read and written (float32)."""
    clips, frames, n, hop, bins = shape(config, workload)
    return 4 * clips * (2 * frames * n + 4 * frames * bins + frames * bins
                        + 2 * ((frames - 1) * hop + n))
