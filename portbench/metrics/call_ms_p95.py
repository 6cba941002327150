"""95th percentile of the host-clock latency of every offline call in the
window, from entry to synchronised output."""
from ._latency import p95_ms


def read(run):
    return p95_ms(run, "call")
