"""Device idle time between a call's first and last main-kernel launches
(or, for pushes, between the first push's and the last push's kernels of
the traced window), per unit of work: one Griffin-Lim iteration or one
RTISI-LA output-frame step of every clip or stream (us/unit).  The main
kernels are the configuration's ``kernels.main``."""
from __future__ import annotations

from ._trace import idle_between, matching, spans_with_units


def read(run):
    if run.trace is None:
        return None
    kernels = matching(run.trace, run.config["kernels"]["main"])
    calls = spans_with_units(run, ("portbench.call",))
    groups = calls or [(min(a for a, _, _ in s), max(b for _, b, _ in s), sum(u for *_, u in s))
                       for s in [spans_with_units(run, ("portbench.push", "portbench.flush"))]
                       if s]
    idle, units = 0.0, 0
    for a, b, n in groups:
        inside = [(ka, kb) for _, ka, kb in kernels if a <= ka <= b]
        if not inside:
            continue
        idle += idle_between(run.trace, min(k[0] for k in inside), max(k[1] for k in inside))
        units += n
    return idle / units if units else None
