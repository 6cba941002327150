"""The tail of the host-clock latencies of one kind of record."""
from __future__ import annotations

from ..core import percentile


def p95_ms(run, kind: str):
    """95th percentile, in ms, of every ``kind`` record of the window, from
    entry to synchronised output; a failed one counts as never done (the
    window's length)."""
    lat = [(r.end - r.start) * 1e3 if r.ok else run.window_s * 1e3
           for r in run.records if r.kind == kind]
    return percentile(lat, 95) if lat else None
