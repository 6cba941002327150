"""Live streams, closed loop: one ``RTISIStreamer`` carries ``streams``
streams, each ``push`` advances every stream by one magnitude frame and
waits for the samples it returns; after the last frame of the streams'
utterances, ``flush`` drains the look-ahead and a new streamer takes the
next utterances, back to back, all inside the window.

The cell's file sets ``streams``, ``pool`` (utterance groups made at
set-up, played in turn), ``warmup_pushes`` (one streamer's pushes and its
flush before the window) and what the check compares, each a seeded draw:
pushes at ``check_rate`` (from the look-ahead's first emitted samples on,
where the streamer has a state to start from), utterance starts at
``start_rate`` and flushes at ``flush_rate``, the window's first of each
always.  A push counts ``streams * hop / sample_rate`` audio seconds (one
frame step of every stream) once its samples are ready, after
``torch.cuda.synchronize()``.  What the check reads of the streamer's
internals is listed in ``INTERNALS``; set-up fails naming any the program
no longer has.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .. import inputs
from ..core import Record

# The streamer's internals that the check reads, and the launch function it
# taps (``inputs.Tap``) for the state an utterance's first step starts from.
INTERNALS = {"state": "the state (keeped, update, pre) before and after a push",
             "_ola_buf": "the overlap buffer a push adds its committed frame to",
             "_pending": "the magnitude frames a flush still has to step",
             "_warmup": "the commits still to be dropped"}
LAUNCH = ("specinv_tpu_torch.ops.cuda.rtisi_fused", "fused_rtisi_steps")


def _held(st, name: str):
    """One of the streamer's internals that the check starts from."""
    return inputs.internal(st, name, INTERNALS[name])


def setup(run) -> None:
    cfg, wl = run.config, run.workload
    t = time.perf_counter()
    streams, pool = wl["streams"], wl["pool"]
    mags = inputs.magnitudes(cfg, streams * pool, run.seed, run.device)
    w32, w64 = inputs.hann(cfg["n_fft"], run.device)
    # (T, streams, F) per utterance group: push t takes row t
    groups = [mags[g * streams : (g + 1) * streams].permute(2, 0, 1).contiguous()
              for g in range(pool)]
    cls = inputs.entry(cfg, "stream_push")
    kwargs = dict(cfg["call"], batch=streams, dtype=torch.float32, window=w32,
                  hop_length=cfg["hop_length"])
    draws = {"push": ("check_rate", "check_pushes"), "start": ("start_rate", "check_starts"),
             "flush": ("flush_rate", "check_flushes")}
    run.state.update(groups=groups, cls=cls, kwargs=kwargs, w64=w64, w32=w32, draws=draws,
                     picks={kind: inputs.chosen(run.seed + k, wl[rate])
                            for k, (kind, (rate, _)) in enumerate(draws.items())})
    inputs.sync(run)
    run.setup["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    st = cls(cfg["n_fft"] // 2 + 1, **kwargs)
    for row in groups[0][: wl["warmup_pushes"]]:
        st.push(row)
        inputs.sync(run)
    # what a compared push keeps: the states before and after, the overlap buffer
    # (and, here in set-up, a clear failure where the program no longer has them)
    for name in INTERNALS:
        _held(st, name)
    inputs.Tap(*LAUNCH)
    sizes = [x.numel() * x.element_size() for x in (*st.state, st._ola_buf)]
    st.flush()
    inputs.sync(run)
    compared = wl["check_pushes"] + wl["check_starts"] + wl["check_flushes"]
    inputs.reserve(run.device, sizes, 2 * compared)
    run.setup["warmup_s"] = time.perf_counter() - t


def window(run, seconds: float, spans: bool) -> None:
    from torch.profiler import record_function

    cfg, wl = run.config, run.workload
    groups, cls, kwargs = run.state["groups"], run.state["cls"], run.state["kwargs"]
    la, hop = cfg["call"]["look_ahead"], cfg["hop_length"]
    audio = wl["streams"] * hop / cfg["sample_rate"]
    n_frames = groups[0].shape[0]
    draws, picks = run.state["draws"], run.state["picks"]
    seen = dict.fromkeys(draws, 0)
    taken = dict.fromkeys(draws, 0)

    def pick(kind) -> bool:
        i = seen[kind]
        seen[kind] += 1
        if (i == 0 or i in picks[kind]) and taken[kind] < wl[draws[kind][1]]:
            taken[kind] += 1
            return True
        return False

    def span(name):
        return record_function(name) if spans else contextlib.nullcontext()

    def new_streamer():
        return cls(cfg["n_fft"] // 2 + 1, **kwargs)

    start = time.perf_counter()
    deadline, g, t, st = start + seconds, 0, 0, new_streamer()
    while True:
        rows = groups[g % len(groups)]
        keep = None
        if t == 0 and pick("start"):
            keep = {"kind": "start", "group": g % len(groups)}
        elif t >= la and pick("push"):
            keep = {"kind": "push", "group": g % len(groups), "t": t,
                    "before": _held(st, "state"), "ola": _held(st, "_ola_buf")}
        tap = inputs.Tap(*LAUNCH) if keep and keep["kind"] == "start" else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with span("portbench.push"), tap:
                y = st.push(rows[t])
                inputs.sync(run)
            ok = True
        except Exception as exc:  # a failed push completes nothing
            y, ok = None, False
            run.errors.append(repr(exc))
        t1 = time.perf_counter()
        run.records.append(Record(t0, t1, audio if ok else 0.0, 1, ok, "push"))
        if keep and ok:
            keep.update(after=_held(st, "state"), out=y)
            if keep["kind"] == "start":
                keep["launch"] = tap.calls[0][0] if tap.calls else None
            run.sample.append(keep)
        t += 1
        if t == n_frames and t1 < deadline:  # the utterances end: drain, then new streams
            keep = None
            if pick("flush"):
                keep = {"kind": "flush", "group": g % len(groups),
                        "before": _held(st, "state"), "ola": _held(st, "_ola_buf"),
                        "warmup": _held(st, "_warmup"),
                        "pending": torch.stack(_held(st, "_pending"), dim=1)}
            t0 = time.perf_counter()
            try:
                with span("portbench.flush"):
                    y = st.flush()
                    inputs.sync(run)
                ok = True
            except Exception as exc:
                y, ok = None, False
                run.errors.append(repr(exc))
            g, t, st = g + 1, 0, new_streamer()
            t1 = time.perf_counter()
            run.records.append(Record(t0, t1, 0.0, la, ok, "flush"))
            if keep and ok:
                keep["out"] = y
                run.sample.append(keep)
        if t1 >= deadline:
            break
    run.window_s = t1 - start
    run.state.pop("cls")
