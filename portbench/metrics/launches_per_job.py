"""launches_per_job: stencil kernel launches a job of the measured window
made, from the port's counters (`cuda_lib.RING_STENCIL` and
`cuda_lib.ADDRESSABLE_STEP` ``.launches``)."""

COUNTERS = ("RING_STENCIL", "ADDRESSABLE_STEP")


def read(ctx):
    if not ctx.jobs or not any(ctx.launches.get(k) for k in COUNTERS):
        return None
    return sum(ctx.launches.get(k, 0) for k in COUNTERS) / ctx.jobs
