"""Live RTISI-LA streams: each compared push, utterance start and flush
against the float64 reference (``reference/rtisi_la.py``).

RTISI-LA amplifies a rounding about twice per committed frame, and from
some states a step of 25 refinements lets one rounding decide the phase of
a few bins: float64 itself moves by a per cent there under a perturbation
of one float32 rounding.  So the reference follows the program step by
step, each compared push from the streamer's own state before it (its
committed frames, in-flight frames, momentum and overlap buffer), and the
start and the hand-over between pushes are checked by themselves:

* ``seed_dist``: the worst, over compared utterance starts and streams, of
  the state the first push's launch started from (the zero-phase inverse of
  the first frame, zeros elsewhere), its windows and its target rows,
  against the reference's own start;
* ``step_p75``: the 75th percentile, over compared pushes and streams, of
  the larger of the samples the push returned and the committed frames it
  left, against the reference step from the state before it;
* ``state_p50``: the median, over the same, of the larger of the in-flight
  frames and the momentum the push left (where a step's rounding lottery
  shows first);
* ``flush_p50``: the median, over compared flushes and streams, of the
  samples ``flush`` returned against the reference's drain from the state
  before it.

Each distance is ``||ours - reference|| / ||reference||`` per stream.  With
``control`` the reference computed with every stored value rounded to
bfloat16 takes the program's place, from the same states.

The check reads internals of the program: the streamer's ``state``,
``_ola_buf``, ``_pending`` and ``_warmup`` (``drivers/stream_push.py``'s
``INTERNALS``) and the arguments of ``rtisi_fused.fused_rtisi_steps``
(``checks/_rtisi.py``).  A run whose program lacks one fails in set-up with
a message that names it.
"""
from __future__ import annotations

import torch

from ..reference import rtisi_la as reference
from ..reference._signal import bf16_keep
from ._distance import rel, wide, worst
from ._rtisi import low as _low
from ._rtisi import start_dists


def compare(run, control: bool = False) -> list:
    cfg, limits = run.config, run.workload["limits"]
    la, hop = cfg["call"]["look_ahead"], cfg["hop_length"]
    it, alpha = cfg["call"]["max_iter"], cfg["reference"]["alpha"]
    w64 = run.state["w64"]
    w32 = w64.float()
    seeds, steps, states, flushes = [], [], [], []
    for s in run.sample:
        rows = run.state["groups"][s["group"]]  # (T, streams, F)
        if s["kind"] == "start":
            first = rows[0]
            start_rows = torch.cat([first.new_zeros((first.shape[0], la, first.shape[1])),
                                    first[:, None]], dim=1)
            seeds += start_dists(s["launch"], first, start_rows, la, hop, it, alpha, w64,
                                 control)
        elif s["kind"] == "push":
            target = rows[s["t"] - la : s["t"] + 1].transpose(0, 1)
            (keeped, update, pre), committed = reference.step(
                tuple(map(wide, s["before"])), wide(target), w64, hop, it, alpha)
            out, _ = reference.emit(wide(s["ola"]), committed, w64, hop)
            if control:
                after, low = reference.step(tuple(map(_low, s["before"])), _low(target), w32,
                                            hop, it, alpha, bf16_keep)
                ours = bf16_keep(reference.emit(_low(s["ola"]), low, w32, hop)[0])
            else:
                after, ours = s["after"], s["out"]
            steps += [max(a, b) for a, b in zip(rel(ours, out), rel(after[0], keeped))]
            states += [max(a, b) for a, b in zip(rel(after[1], update), rel(after[2], pre))]
        else:
            expected = reference.flush(tuple(map(wide, s["before"])), wide(s["ola"]),
                                       wide(s["pending"]), s["warmup"], w64, hop, it, alpha)
            ours = s["out"]
            if control:
                ours = reference.flush(tuple(map(_low, s["before"])), _low(s["ola"]),
                                       _low(s["pending"]), s["warmup"], w32, hop, it, alpha,
                                       bf16_keep)
            flushes += rel(ours, expected)

    return [("seed_dist", worst(seeds, 100), limits["seed_dist"]),
            ("step_p75", worst(steps, 75), limits["step_p75"]),
            ("state_p50", worst(states, 50), limits["state_p50"]),
            ("flush_p50", worst(flushes, 50), limits["flush_p50"])]
