"""Device time of kernel A (the whole-run Griffin-Lim kernel's frame and
overlap-add launches) per Griffin-Lim iteration of a call's clips."""
from ._kernel import us_per_unit

KERNELS = ("frame_kernel", "ola_kernel")


def read(run):
    return us_per_unit(run, KERNELS)
