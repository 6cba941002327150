"""The whole step's share of the card's float32 peak: the operations the
algorithm needs for the traced window's units of work (``roofline/<work>``,
``work`` named by the configuration), over the window's length and the peak
(%).  It bounds every kernel's roofline share from above, so a kernel taken
off the path cannot hide a loss."""
from ..core import load_module
from ..roofline._peaks import PEAKS
from ._kernel import units


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace["window"]
    flops = load_module("roofline", run.config["work"]).flops(run.config, run.workload)
    return 100.0 * flops * units(run) / ((hi - lo) / 1e6 * PEAKS["fp32_flops_per_s"])
