"""The peaks, and the least time of a piece of work against them."""
from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def rfft_flops(n: int) -> float:
    """One real FFT of ``n`` points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the float32 operations' and the bytes' times."""
    return max(flops / PEAKS["fp32_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])
