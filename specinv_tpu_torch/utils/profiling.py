"""Profiling and tracing hooks.

Counterpart of ``specinv_tpu/utils/profiling.py`` on ``torch.profiler``: a
trace of the enclosed block for TensorBoard / Perfetto, named regions inside
it, and an iteration-throughput timer.

Beside them, the port's own spans and its count of host syncs.  :func:`span`
names a stage of the port (``specinv.call``, ``.prep``, ``.seed``,
``.loop``, ``.launch``, ``.state``, ``.synth``, ``.push``, ``.flush``) as a
function-scope range on the profiler's clock: it records while a
``torch.profiler`` records and costs well under a microsecond otherwise, and
it never becomes device activity in the trace.  :func:`host_sync` wraps each
place where the host waits for the card, adds one to :data:`host_syncs` and
opens ``specinv.host_sync`` around the wait.
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

try:  # a function-scope range: no device-side twin, near free with no profiler
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # an older torch: spans record nothing
    _RecordFunctionFast = None

_NOTHING = contextlib.nullcontext()

# Host syncs of the port on a card tensor: blocking copies between the host
# and the card, and reads of a card value (one per :func:`host_sync`).
host_syncs = 0


def span(name: str):
    """A stage of the port, ``specinv.<name>``, in the trace of a running
    ``torch.profiler``; nested spans nest on the calling thread::

        with span("prep"):
            ...
    """
    if _RecordFunctionFast is None:
        return _NOTHING
    return _RecordFunctionFast("specinv." + name)


def host_sync(where):
    """Around an operation that makes the host wait for the card: counts one
    in :data:`host_syncs` and opens ``span("host_sync")`` when ``where`` (the
    tensor read or written, or the device copied to) is on a CUDA card, and
    does nothing otherwise (a host value, a CPU tensor or device)::

        with host_sync(window):
            window = window.cpu()
    """
    if isinstance(where, torch.Tensor):
        on_card = where.is_cuda
    elif isinstance(where, (str, torch.device)):
        on_card = torch.device(where).type == "cuda"
    else:  # a host value
        on_card = False
    if not on_card:
        return _NOTHING
    global host_syncs
    host_syncs += 1
    return span("host_sync")


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
