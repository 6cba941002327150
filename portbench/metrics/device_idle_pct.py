"""1 minus the union of the device's activity over the traced window (%)."""
from ..core import union_us


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace["window"]
    return 100.0 * (1.0 - union_us((a, b) for _, a, b in run.trace["kernels"]) / (hi - lo))
