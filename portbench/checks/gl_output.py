"""Offline Griffin-Lim: each compared call's waveforms against the float64
reference run on the same magnitudes (``reference/griffin_lim.py``, its own
SPSI seed and stop rule, the whole batch of the call).

Two numbers over the compared clips:

* ``sc_gap_p50``: the median of the gap between the program's and the
  reference's spectral convergence, ``20 log10 ||(|STFT(y)| - |X|)|| /
  |||X|||`` against the target magnitude, in dB.  Two correct runs reach
  equally consistent waveforms; a lower precision or missing iterations do
  not.  The median, because the float32 SPSI seed starts some clips on
  another path: float32 implementations lie a few hundredths of a dB from
  float64 on most clips and up to some tenths on one clip in a hundred.
* ``wave_dist``: the worst ``||y - y_ref|| / ||y_ref||``.  The float32 SPSI
  seed's phase sums lie up to a few hundredths of a radian from float64 by
  the end of a clip, so correct waveforms differ by some per cent; a clip
  that is lost, another clip's, shifted, negated or scaled, or a seed
  summed in a lower precision, differs by its whole size.

With ``control`` the reference computed with every stored value rounded to
bfloat16 (the SPSI seed's sums included) takes the program's place.
"""
from __future__ import annotations

import torch

from ..reference import griffin_lim as reference
from ..reference._signal import bf16_keep, stft
from ._distance import rel, worst


def sc_db(y: torch.Tensor, target_tm: torch.Tensor, window: torch.Tensor, hop: int) -> list:
    """Per clip: the spectral convergence of ``y (B, L)`` against ``target_tm
    (B, T, F)``, in dB, in float64."""
    err = stft(y.double(), window, hop).abs() - target_tm
    num = err.flatten(1).norm(dim=1)
    den = target_tm.flatten(1).norm(dim=1)
    return (20 * (torch.log10(num) - torch.log10(den))).tolist()


def compare(run, control: bool = False) -> list:
    cfg, limits = run.config, run.workload["limits"]
    hop, w64 = cfg["hop_length"], run.state["w64"]
    args = dict(hop=hop, max_iter=cfg["call"]["max_iter"], **cfg["reference"])
    gaps, dists = [], []
    for index, y, _ in run.sample:
        mag = run.state["calls"][index]
        if control:
            y = reference.invert(mag, w64.float(), keep=bf16_keep, **args)
        expected = reference.invert(mag.double(), w64, **args)
        target = mag.double().transpose(-1, -2)
        ours, theirs = sc_db(y, target, w64, hop), sc_db(expected, target, w64, hop)
        gaps += [abs(a - b) for a, b in zip(ours, theirs)]
        dists += rel(y, expected)
        del expected, target
    return [("sc_gap_p50", worst(gaps, 50), limits["sc_gap_p50"]),
            ("wave_dist", worst(dists), limits["wave_dist"])]
