"""addressable_roofline: the addressable step's (`csrc/addressable_step.cu`)
share of its roofline, in percent: one launch's least time over its mean
device time in the trace."""
from portbench.lib.roofline import launch_share

KERNELS = ("band_step", "jacobi1d_step")
COUNTER = "ADDRESSABLE_STEP"


def read(ctx):
    return launch_share(ctx, KERNELS, COUNTER)
