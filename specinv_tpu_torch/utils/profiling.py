"""Profiling and tracing hooks.

Counterpart of ``specinv_tpu/utils/profiling.py`` on ``torch.profiler``: a
trace of the enclosed block for TensorBoard / Perfetto, named regions inside
it, and an iteration-throughput timer.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
from torch.utils import _pytree as pytree


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Capture a trace of the enclosed block into ``log_dir`` (a
    ``*.pt.trace.json`` file), the card's activity included when there is
    one; yields the ``torch.profiler.profile`` (``key_averages()``, ``events()``)::

        with trace("traces/gl"):
            griffin_lim(mag, max_iter=100, verbose=False)
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


annotate = torch.profiler.record_function  # a named region inside a trace


def _on_card(out) -> bool:
    return any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
               for leaf in pytree.tree_leaves(out))


class Throughput:
    """Sustained iterations per second of a run.

    >>> tp = Throughput()
    >>> y = tp.measure(lambda: griffin_lim(mag, max_iter=1000, tol=0.0,
    ...                                    verbose=False), iters=1000)
    >>> tp.iters_per_sec

    A run whose output lies on the card is timed with CUDA events around
    the call (its device work included); one on the CPU with the host
    clock.
    """

    def __init__(self):
        self.iters_per_sec = None
        self.seconds = None

    def measure(self, fn, iters: int, warmup: bool = True):
        if warmup:
            fn()
        events = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        out = fn()
        if events is not None and _on_card(out):
            events[1].record()
            torch.cuda.synchronize()
            self.seconds = events[0].elapsed_time(events[1]) / 1e3
        else:
            self.seconds = time.perf_counter() - t0
        self.iters_per_sec = iters / self.seconds
        return out
