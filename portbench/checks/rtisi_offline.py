"""Offline RTISI-LA: each compared call's launches of the program's RTISI-LA
kernel and its waveform against the float64 reference
(``reference/rtisi_la.py``).

RTISI-LA amplifies a rounding several times over per step, and from some
states a step of 25 refinements lets one rounding decide the phase of a few
bins, so two correct float32 runs of a whole clip, or of the eight steps of
one launch, need not agree (``chain_p50`` below).  The reference therefore
follows the program launch by launch, each from the state the program
handed that launch, and the start, the hand-over and the synthesis are
checked by themselves:

* ``feed_dist``: the worst, over streams, of the first launch's state,
  windows and parameters against the reference's start from the first
  magnitude frame; every launch's target rows against the magnitudes
  padded with ``la`` zero frames on both sides at that launch's offset;
  every launch's state against the state the launch before returned
  (the hand-over: the same tensors, so 0); the committed frames a launch
  returns in its state against those it committed, as the reference's
  step keeps them (exact); infinite where the launches do not cover the
  call's ``T + la`` steps;
* ``step_p75``: the 75th percentile, over launches and streams, of the
  first frame a launch commits against the reference's step from the
  launch's state;
* ``chain_p50``: the median, over launches and streams, of the worst of the
  later committed frames and the state the launch returns against the
  reference's steps from the same state;
* ``wave_dist``: the worst, over streams, of the returned waveform against
  the reference's synthesis (``reference.synthesize``) of the frames that
  the program's launches committed, the first ``la`` dropped.

Each distance is ``||ours - reference|| / ||reference||`` per stream.  With
``control`` the reference computed with every stored value rounded to
bfloat16 takes the program's place, from the same states.  The check reads
the arguments and results of ``rtisi_fused.fused_rtisi_steps``, the
program's launch function (``checks/_rtisi.py``), taken by the workload's
``tap``; a run whose program lacks it fails in set-up with a message that
names it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..reference import rtisi_la as reference
from ..reference._signal import bf16_keep
from ._distance import rel, wide, worst
from ._rtisi import low, start_dists


def _launch(args, out, rows, w64, hop, it, alpha, control):
    """Per stream: the first committed frame's distance and the worst of the
    later frames and the returned state, from the launch's own state; and
    the committed frames ``(k, B, n)`` (the control's own with ``control``)."""
    start = args[:3]
    la = start[1].shape[1] - 1
    k = rows.shape[1] - la
    expected, low_state = tuple(map(wide, start)), tuple(map(low, start))
    ref_frames, low_frames = [], []
    for i in range(k):
        expected, frame = reference.step(expected, wide(rows[:, i : i + la + 1]), w64, hop, it,
                                         alpha)
        ref_frames.append(frame)
        if control:
            low_state, frame = reference.step(low_state, low(rows[:, i : i + la + 1]),
                                              w64.float(), hop, it, alpha, bf16_keep)
            low_frames.append(frame)
    committed, state = (torch.stack(low_frames), low_state) if control else (out[0], out[1:])
    first = rel(committed[0], ref_frames[0])
    later = [rel(committed[i], ref_frames[i]) for i in range(1, k)]
    later += [rel(state[1], expected[1]), rel(state[2], expected[2])]
    return first, [max(v) for v in zip(*later)], committed


def compare(run, control: bool = False) -> list:
    cfg, limits = run.config, run.workload["limits"]
    la, hop = cfg["call"]["look_ahead"], cfg["hop_length"]
    it, alpha = cfg["call"]["max_iter"], cfg["reference"]["alpha"]
    w64 = run.state["w64"]
    feeds, steps, chains, waves = [], [], [], []
    for index, y, launches in run.sample:
        mag = run.state["calls"][index]
        padded = F.pad(mag.transpose(-1, -2), (0, 0, la, la))  # (B, T + 2 la, F)
        total = padded.shape[1] - la
        done, frames, before = 0, [], None
        per_stream = [0.0] * mag.shape[0]
        for n, (args, out) in enumerate(launches):
            k = args[3].shape[1] - la
            rows = padded[:, done : done + k + la]
            if args[3].shape != rows.shape:  # a launch that reads other rows
                done = math.inf
                break
            if n == 0:
                per_stream = start_dists(args, mag[..., 0], rows, la, hop, it, alpha, w64,
                                         control)
            else:
                per_stream = [max(v) for v in zip(per_stream, *(
                    rel(a, b) for a, b in zip(args[:3], before)))]
            kept = torch.cat([args[0], out[0].transpose(0, 1)], dim=1)[:, -args[0].shape[1]:]
            per_stream = [max(v) for v in zip(per_stream, rel(args[3], rows),
                                               rel(out[1], kept))]
            first, later, committed = _launch(args, out, rows, w64, hop, it, alpha, control)
            steps += first
            chains += later
            frames.append(committed)
            before, done = out[1:], done + k
        feeds += per_stream if done == total and launches else [math.inf] * mag.shape[0]
        if done != total or not launches:
            waves += [math.inf] * mag.shape[0]
            continue
        frames = torch.cat(frames)[la:].transpose(0, 1)  # (B, T, n)
        expected = reference.synthesize(wide(frames), w64, hop)
        if control:
            y = reference.synthesize(low(frames), w64.float(), hop, bf16_keep)
        waves += rel(y, expected)
    return [("feed_dist", worst(feeds, 100), limits["feed_dist"]),
            ("step_p75", worst(steps, 75), limits["step_p75"]),
            ("chain_p50", worst(chains, 50), limits["chain_p50"]),
            ("wave_dist", worst(waves, 100), limits["wave_dist"])]
