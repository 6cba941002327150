"""``roofline/rtisi_step``'s least time for one output-frame step of every
stream over kernel D's device time per step (%)."""
from ._kernel import roofline_pct
from .kernelD_us_per_step import KERNELS


def read(run):
    return roofline_pct(run, KERNELS, "rtisi_step")
