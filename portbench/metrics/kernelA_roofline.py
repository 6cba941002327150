"""``roofline/gl_iteration``'s least time for one iteration of a call's
clips over kernel A's device time per iteration (%)."""
from ._kernel import roofline_pct
from .kernelA_us_per_iter import KERNELS


def read(run):
    return roofline_pct(run, KERNELS, "gl_iteration")
