"""The port's own spans (``utils/profiling.span``) and its count of host
syncs (``utils/profiling.host_sync``).

On the CPU: the span tree of each entry point under ``torch.profiler`` (the
kernels' plain versions run there), the spans' scope, and no count on CPU
tensors.  On the card (marked ``cuda``, skipped without one; from the root
of a checkout: ``python -m pytest tests/test_torch_spans.py -m cuda
--noconftest -q``): the count equals the warnings of torch's sync debug
mode over the same calls, and no span becomes device activity.
"""
import collections
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import specinv_tpu_torch as st
from specinv_tpu_torch.utils import profiling

N_FFT, HOP = 256, 64
BINS = N_FFT // 2 + 1


def _mag(device, batch=2, frames=20):
    gen = torch.Generator().manual_seed(7)
    return torch.rand(batch, BINS, frames, generator=gen).to(device)


def _window(device):
    return torch.hann_window(N_FFT).to(device)


def _stream(mag, window, pushes):
    """A new streamer, ``pushes`` pushes of ``mag``'s frames and a flush."""
    streamer = st.RTISIStreamer(BINS, look_ahead=3, max_iter=2, batch=mag.shape[0],
                                backend="kernel", window=window, hop_length=HOP)
    for t in range(pushes):
        streamer.push(mag[:, :, t])
    return streamer.flush()


def calls(device):
    """Each entry point as the benchmark's cells call it, at a small size."""
    mag, w = _mag(device), _window(device)
    kw = dict(window=w, hop_length=HOP)
    return {
        # 12 iterations: an eval segment of 10 and a tail of 2, two launches
        "griffin_lim": lambda: st.griffin_lim(mag, max_iter=12, backend="kernel",
                                              verbose=False, **kw),
        "griffin_lim_no_eval": lambda: st.griffin_lim(mag, max_iter=12, tol=0.0,
                                                      backend="kernel", verbose=False, **kw),
        "ADMM": lambda: st.ADMM(mag, max_iter=12, backend="kernel", verbose=False, **kw),
        # the direct-DFT path: one launch per iteration (the plain version here)
        "griffin_lim_dft": lambda: st.griffin_lim(mag, max_iter=12, backend="dft",
                                                  verbose=False, **kw),
        "ADMM_dft": lambda: st.ADMM(mag, max_iter=12, backend="dft", verbose=False, **kw),
        # 20 frames and 3 of look-ahead: 23 steps, launches of 8, 8 and 7
        "RTISI_LA": lambda: st.RTISI_LA(mag, look_ahead=3, max_iter=2, backend="kernel",
                                        verbose=False, **kw),
        # every push steps (the look-ahead starts full of zero frames), the first 3
        # commits are dropped, the flush steps the 3 frames still pending
        "stream": lambda: _stream(mag, w, pushes=6),
    }


# (parent span, span) -> count, for each call of ``calls``
CALL = {(None, "call"): 1, ("call", "prep"): 1, ("call", "seed"): 2, ("call", "loop"): 1,
        ("call", "synth"): 2}
TREES = {
    "griffin_lim": {**CALL, ("loop", "launch"): 2},
    "griffin_lim_no_eval": {**CALL, ("loop", "launch"): 1},
    "ADMM": {**CALL, ("loop", "launch"): 2},
    "griffin_lim_dft": {**CALL, ("loop", "launch"): 12},
    "ADMM_dft": {**CALL, ("loop", "launch"): 12},
    "RTISI_LA": {**CALL, ("call", "prep"): 2, ("call", "seed"): 1, ("loop", "launch"): 3},
    "stream": {(None, "push"): 6, ("push", "seed"): 2, ("push", "prep"): 6,
               ("push", "launch"): 6, ("push", "state"): 6, ("push", "synth"): 3,
               (None, "flush"): 1, ("flush", "prep"): 3, ("flush", "launch"): 3,
               ("flush", "state"): 3, ("flush", "synth"): 4},
}


def _port_events(prof):
    return [e for e in prof.events() if e.name.startswith("specinv.")]


def _tree(events) -> dict:
    """(nearest enclosing span, span) -> count, without the ``specinv.``."""
    tree = collections.Counter()
    for e in events:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("specinv."):
            parent = parent.cpu_parent
        tree[(parent and parent.name[8:], e.name[8:])] += 1
    return dict(tree)


def test_the_installed_torch_has_the_fast_range():
    from torch._C._profiler import _RecordFunctionFast

    assert profiling._RecordFunctionFast is _RecordFunctionFast
    assert isinstance(profiling.span("call"), _RecordFunctionFast)


def test_without_a_profiler_spans_leave_no_event():
    with profiling.span("call"), profiling.span("prep"):
        with profiling.host_sync(torch.device("cuda")):  # counts, with no card too
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(3).add_(1)
    assert _port_events(prof) == []


def test_without_the_fast_range_a_span_is_the_shared_no_op(monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", None)
    assert profiling.span("call") is profiling.span("loop") is profiling._NOTHING
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("call"):
            torch.zeros(3).add_(1)
    assert _port_events(prof) == []


@pytest.mark.parametrize("where", [torch.zeros(2), "cpu", torch.device("cpu"), 3.0, None])
def test_host_sync_counts_only_the_card(where):
    before = profiling.host_syncs
    assert profiling.host_sync(where) is profiling._NOTHING
    assert profiling.host_syncs == before


def test_host_sync_on_the_card_counts_one_and_opens_its_span():
    before = profiling.host_syncs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("call"), profiling.host_sync("cuda:0"):
            pass
    assert profiling.host_syncs == before + 1
    assert _tree(_port_events(prof)) == {(None, "call"): 1, ("call", "host_sync"): 1}


@pytest.mark.parametrize("name", sorted(TREES))
def test_span_tree_of_each_entry(name):
    fn = calls("cpu")[name]
    before = profiling.host_syncs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = _port_events(prof)
    assert _tree(events) == TREES[name]
    assert profiling.host_syncs == before  # CPU tensors: no host sync
    # function scope (as an aten op), on the CPU: never a user range with a
    # device-side twin, which a trace reader would count as device activity
    assert all(e.scope == 0 for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)


@pytest.mark.parametrize("name", sorted(TREES))
def test_spans_nest_inside_their_entry(name):
    """Every stage lies inside its entry span, and stages of one entry do not
    overlap (a breakdown names the innermost one open)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls("cpu")[name]()
    events = sorted(_port_events(prof), key=lambda e: e.time_range.start)
    roots = [e for e in events if e.name in ("specinv.call", "specinv.push", "specinv.flush")]
    for root in roots:
        lo, hi = root.time_range.start, root.time_range.end
        stages = [e for e in events if e.cpu_parent is root]
        assert all(lo <= e.time_range.start <= e.time_range.end <= hi for e in stages)
        for a, b in zip(stages, stages[1:]):
            assert a.time_range.end <= b.time_range.start


def test_verbose_and_while_read_back_nothing_on_the_cpu(capsys):
    mag, w = _mag("cpu"), _window("cpu")
    before = profiling.host_syncs
    st.griffin_lim(mag, max_iter=20, backend="kernel", verbose=True, mode="while",
                   window=w, hop_length=HOP)
    assert profiling.host_syncs == before
    assert "iter 10:" in capsys.readouterr().out


# -- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_calls(dev):
    """The cells' calls at a small size on the card, with a verbose 'while'
    call beside them (the progress reads and the stop read)."""
    mag, w = _mag(dev), _window(dev)
    out = calls(dev)
    out["verbose_while"] = lambda: st.griffin_lim(mag, max_iter=20, backend="kernel",
                                                  verbose=True, mode="while", window=w,
                                                  hop_length=HOP)
    return out


def _sync_warnings(fn) -> list:
    """Where torch's sync debug mode warns while ``fn`` runs: one
    ``file:line`` per synchronizing operation it detects."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
def test_host_syncs_equal_torch_sync_debug_warnings(dev, capsys):
    wrong = {}
    for name, fn in _card_calls(dev).items():
        torch.cuda.synchronize()
        before = profiling.host_syncs
        warned = _sync_warnings(fn)
        counted = profiling.host_syncs - before
        assert counted, name  # the window's round trip at least
        if counted != len(warned):
            wrong[name] = (counted, dict(collections.Counter(warned)))
    assert not wrong, wrong


@pytest.mark.cuda
def test_no_span_is_device_activity(dev, capsys):
    fns = _card_calls(dev)
    for fn in fns.values():  # built and warm
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    assert not [e.name for e in events if e.name.startswith("specinv.")
                and e.device_type == torch.autograd.DeviceType.CUDA]
    names = {e.name for e in events if e.name.startswith("specinv.")}
    assert {"specinv.call", "specinv.push", "specinv.flush", "specinv.launch",
            "specinv.host_sync"} <= names
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
