"""One caller, closed loop: each call inverts a batch of clips and waits for
the waveform, then the next call starts.

The cell's file sets ``batch`` (clips per call), ``pool`` (distinct
batches made at set-up, called in turn), ``warmup_calls``, and which calls the check
compares: the window's first and a seeded draw at ``check_rate``, at most
``check_calls``.  With ``tap`` (a module of the program and a function in
it) a compared call also keeps the arguments and results of every call of
that function it makes (``inputs.Tap``), for a check that follows the
program's launches.  ``units_per_call`` is a call's units of work (GL
iterations, RTISI-LA steps), ``call`` adds arguments to the
configuration's.  A call counts its clips' audio seconds once its output is
ready, after ``torch.cuda.synchronize()``; a call that raises counts as
failed and completes no audio.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .. import inputs
from ..core import Record


def setup(run) -> None:
    cfg, wl = run.config, run.workload
    t = time.perf_counter()
    batch, pool = wl["batch"], wl["pool"]
    mags = inputs.magnitudes(cfg, batch * pool, run.seed, run.device)
    w32, w64 = inputs.hann(cfg["n_fft"], run.device)
    calls = [mags[i * batch : (i + 1) * batch] for i in range(pool)]
    run.state.update(calls=calls, fn=inputs.entry(cfg, "offline_call"), w64=w64,
                     kwargs=dict(cfg["call"], **wl.get("call", {}), window=w32,
                                 hop_length=cfg["hop_length"]),
                     picked=inputs.chosen(run.seed, wl["check_rate"]))
    inputs.sync(run)
    run.setup["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(wl["warmup_calls"]):
        with inputs.Tap(*wl["tap"]) if "tap" in wl else contextlib.nullcontext() as tap:
            y = run.state["fn"](calls[i % pool], **run.state["kwargs"])
            inputs.sync(run)
    # what a compared call keeps: its output and, with a tap, the storage of every
    # tensor its launches took and returned (a view keeps its whole storage)
    kept = [y] + ([x for args, out in tap.calls for x in (*args, *out)] if "tap" in wl else [])
    storages = {}
    for x in kept:
        for part in (x if isinstance(x, tuple) else (x,)):
            if isinstance(part, torch.Tensor):
                storages[part.untyped_storage().data_ptr()] = part.untyped_storage().nbytes()
    inputs.reserve(run.device, list(storages.values()), 2 * wl["check_calls"])
    run.setup["warmup_s"] = time.perf_counter() - t


def window(run, seconds: float, spans: bool) -> None:
    cfg, wl = run.config, run.workload
    calls, fn, kwargs = run.state["calls"], run.state["fn"], run.state["kwargs"]
    audio = wl["batch"] * cfg["clip_seconds"]
    units = wl["units_per_call"]
    picked = run.state["picked"]
    from torch.profiler import record_function

    start = time.perf_counter()
    deadline, i = start + seconds, 0
    while True:
        x = calls[i % len(calls)]
        keep = (i == 0 or i in picked) and len(run.sample) < wl["check_calls"]
        tap = inputs.Tap(*wl["tap"]) if keep and "tap" in wl else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with record_function("portbench.call") if spans else contextlib.nullcontext(), tap:
                y = fn(x, **kwargs)
                inputs.sync(run)
            ok = True
        except Exception as exc:  # a failed call completes nothing
            y, ok = None, False
            run.errors.append(repr(exc))
        t1 = time.perf_counter()
        run.records.append(Record(t0, t1, audio if ok else 0.0, units, ok, "call"))
        if ok and keep:
            run.sample.append((i % len(calls), y, tap.calls if "tap" in wl else None))
        i += 1
        if t1 >= deadline:
            break
    run.window_s = t1 - start
    run.state.pop("fn")
