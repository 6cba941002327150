"""What the trace readers share: which spans and kernels belong together."""
from __future__ import annotations

from ..core import union_us


def matching(trace: dict, patterns) -> list:
    """The device activity whose name holds one of ``patterns``."""
    return [k for k in trace["kernels"] if any(p in k[0] for p in patterns)]


def spans_with_units(run, names) -> list:
    """``(start, end, units)`` of the traced window's spans named in
    ``names``, each with the units of work of its record (they run in the
    same order)."""
    spans = run.trace["spans"]
    if len(spans) != len(run.records):
        raise RuntimeError(f"{len(spans)} spans for {len(run.records)} records")
    return [(a, b, r.units) for (name, a, b), r in zip(spans, run.records) if name in names]


def idle_between(trace: dict, lo: float, hi: float) -> float:
    """Microseconds in ``[lo, hi]`` in which no device activity ran."""
    inside = [(max(a, lo), min(b, hi)) for _, a, b in trace["kernels"] if b > lo and a < hi]
    return (hi - lo) - union_us(inside)
