"""Mean time from the start of the benchmark's span around a call to the
device start of that call's first main-kernel launch: the entry, the
config, the window's round trip, the layout and the SPSI seed (ms).  The
main loop's first kernels are the configuration's ``kernels.first``."""
from __future__ import annotations

from ._trace import matching


def read(run):
    if run.trace is None:
        return None
    starts = sorted(a for _, a, _ in matching(run.trace, run.config["kernels"]["first"]))
    delays = []
    for name, a, b in run.trace["spans"]:
        if name != "portbench.call":
            continue
        first = next((k for k in starts if a <= k <= b), None)
        if first is not None:
            delays.append((first - a) / 1e3)
    return sum(delays) / len(delays) if delays else None
