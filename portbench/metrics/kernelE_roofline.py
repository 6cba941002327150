"""``roofline/gl_iteration``'s least time for one iteration of a call's
clips over kernel E's device time per iteration (%): the algorithm's work,
whatever computes it, not E's direct-DFT products."""
from ._kernel import roofline_pct
from .kernelE_us_per_iter import KERNELS


def read(run):
    return roofline_pct(run, KERNELS, "gl_iteration")
