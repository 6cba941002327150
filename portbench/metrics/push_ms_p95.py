"""95th percentile of the host-clock latency of every ``RTISIStreamer.push``
in the window, synchronised: the frame-step latency a live stream sees."""
from ._latency import p95_ms


def read(run):
    return p95_ms(run, "push")
