"""Device time of kernel E (the direct-DFT Griffin-Lim iteration: the frame
split, the forward and the inverse product, the overlap-add) per
Griffin-Lim iteration of a call's clips."""
from ._kernel import us_per_unit

KERNELS = ("frame_split_kernel", "split_gemm_kernel", "ola_kernel")


def read(run):
    return us_per_unit(run, KERNELS)
