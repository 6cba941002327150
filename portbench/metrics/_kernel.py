"""A kernel's device time per unit of work, and its share of the roofline."""
from __future__ import annotations

from ..core import load_module
from ._trace import matching


def units(run) -> int:
    return sum(r.units for r in run.records if r.ok)


def us_per_unit(run, patterns):
    """Device time of the kernels named by ``patterns`` over the traced
    window's units of work (us/unit); None where none ran."""
    if run.trace is None:
        return None
    found = matching(run.trace, patterns)
    n = units(run)
    if not found or not n:
        return None
    return sum(b - a for _, a, b in found) / n


def roofline_pct(run, patterns, work: str):
    """``roofline/<work>``'s least time per unit over the kernels' device
    time per unit, in per cent."""
    measured = us_per_unit(run, patterns)
    if measured is None:
        return None
    least = load_module("roofline", work).least_seconds(run.config, run.workload) * 1e6
    return 100.0 * least / measured
