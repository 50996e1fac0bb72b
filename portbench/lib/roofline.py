"""A kernel's share of its roofline, from the device trace."""
from __future__ import annotations

from typing import Optional, Sequence

from .peaks import roofline_seconds


def launch_share(ctx, kernels: Sequence[str], counter: str
                 ) -> Optional[float]:
    """Percent of its roofline that a launch of the kernels named
    ``kernels`` reaches: the least time of one launch's work (the sweeps it
    does, the input read once, the output written once) over the mean
    device time a launch took in the trace.  A launch's sweeps are a job's
    over its launches, by ``counter`` in the measured window.  None where
    the trace or the counter has nothing."""
    t = ctx.trace
    if t is None or ctx.work is None or not ctx.jobs:
        return None
    count, seconds = t.kernel_time(kernels)
    launches = ctx.launches.get(counter, 0)
    if not count or seconds <= 0 or not launches:
        return None
    w = ctx.work(ctx.sweeps * ctx.jobs / launches)
    return 100.0 * roofline_seconds(w["flops"], w["bytes"]) / (seconds / count)
