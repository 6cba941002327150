"""Device time of kernel D (the RTISI-LA step kernel) per output-frame step
of every stream."""
from ._kernel import us_per_unit

KERNELS = ("rtisi_steps_kernel",)


def read(run):
    return us_per_unit(run, KERNELS)
