"""Offline Griffin-Lim, held as tightly as its products' precision: the
numbers of ``gl_output`` (the float64 reference from its own SPSI seed),
and beside them the float64 reference run from the program's own seed.

Over a 30 s clip the program's float32 SPSI seed drifts far enough from the
float64 seed (its phase sums run over 3,001 frames) that ``gl_output``'s
waveforms differ by about a quarter, whatever the precision of the
iterations: one bf16 product per transform reads as the three of
``'high'``.  The cell taps the seed the timed call computed
(``griffin_lim.phase_init_tm``, one call per call of the entry) and runs the
reference from its phase, so that what is left between the two is the
iterations' arithmetic:

* ``seeded_gap_p50``: the median |SC gap| (dB) against the reference from
  the program's seed;
* ``seeded_dist_p90``: the 90th percentile over the compared clips of
  ``||y - y_ref|| / ||y_ref||`` against it.  Not the worst: Griffin-Lim
  carries a few clips in a hundred from rounding-level differences to some
  per cent, while a lower precision moves every clip.

``gl_output``'s ``sc_gap_p50`` and ``wave_dist`` (the worst clip) stay, so
that a seed that is wrong, which the seeded reference would follow, or a
clip that is lost still fails.  With ``control`` the reference computed in
bfloat16 takes the program's place in both comparisons.
"""
from __future__ import annotations

from unittest import mock

import torch

from ..reference import griffin_lim as reference
from ..reference._signal import bf16_keep, identity
from . import gl_output
from ._distance import rel, worst


def from_seed(mag: torch.Tensor, phase: torch.Tensor, window: torch.Tensor, keep=identity,
              **args) -> torch.Tensor:
    """The reference's Griffin-Lim of ``mag (B, F, T)`` started from the phase
    ``phase (B, T, F)`` in place of its own SPSI seed."""
    with mock.patch.object(reference, "spsi", lambda *_a, **_k: phase):
        return reference.invert(mag, window, keep=keep, **args)


def compare(run, control: bool = False) -> list:
    cfg, limits = run.config, run.workload["limits"]
    hop, w64 = cfg["hop_length"], run.state["w64"]
    args = dict(hop=hop, max_iter=cfg["call"]["max_iter"], **cfg["reference"])
    gaps, dists = [], []
    for index, y, taps in run.sample:
        mag = run.state["calls"][index]
        (_, seed), = taps  # the call's one SPSI seed, (B, T, F) complex
        phase = torch.angle(seed.to(torch.complex128))
        if control:
            y = from_seed(mag, phase.float(), w64.float(), keep=bf16_keep, **args)
        expected = from_seed(mag.double(), phase, w64, **args)
        target = mag.double().transpose(-1, -2)
        ours = gl_output.sc_db(y, target, w64, hop)
        theirs = gl_output.sc_db(expected, target, w64, hop)
        gaps += [abs(a - b) for a, b in zip(ours, theirs)]
        dists += rel(y, expected)
        del expected, target, phase
    return [*gl_output.compare(run, control),
            ("seeded_gap_p50", worst(gaps, 50), limits["seeded_gap_p50"]),
            ("seeded_dist_p90", worst(dists, 90), limits["seeded_dist_p90"])]
