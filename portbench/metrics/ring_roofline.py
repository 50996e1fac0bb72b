"""ring_roofline: the ring kernel's (`csrc/ring_stencil.cu`) share of its
roofline, in percent: one launch's least time over its mean device time in
the trace."""
from portbench.lib.roofline import launch_share

KERNELS = ("ring_stencil_kernel",)
COUNTER = "RING_STENCIL"


def read(ctx):
    return launch_share(ctx, KERNELS, COUNTER)
