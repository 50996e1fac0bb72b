"""stencil_mfu: the whole job's share of the card's roofline, in percent:
the least time of the job's own work (every sweep's float32 operations at
the CUDA cores' peak, against its input read once and its output written
once) over the traced jobs' mean host time.  The count is the program's,
whatever kernels run the job."""
from portbench.lib.peaks import roofline_seconds


def read(ctx):
    t = ctx.trace
    if t is None or ctx.work is None or t.busy_s <= 0 or not t.jobs:
        return None
    w = ctx.work(ctx.sweeps)
    return 100.0 * roofline_seconds(w["flops"], w["bytes"]) / t.mean_job_s
