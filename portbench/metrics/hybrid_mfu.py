"""hybrid_mfu: the whole request's share of the card's bf16 peak, in percent:
the request's model FLOPs (the reference's ``work``: every product of the
prefill and the decode steps, and the attention scores, counted from the
widths) at the H100's dense bf16 peak, over the traced requests' mean host
time."""
from portbench.lib.tensor_peaks import PEAK_FLOPS_BF16


def read(ctx):
    t, w = ctx.trace, ctx.work
    if t is None or not isinstance(w, dict) or "flops" not in w \
            or t.busy_s <= 0 or not t.jobs:
        return None
    return 100.0 * w["flops"] / PEAK_FLOPS_BF16 / t.mean_job_s
