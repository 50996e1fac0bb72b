"""moe_ms: device milliseconds a request of the operations launched inside
the program's ``hybrid.moe`` spans (the stack's MoE layers, router to
combine, in the prefill; a decode step replays as one CUDA graph under
``serve.decode_step``, its kernels outside these spans), over the traced
requests."""

SPAN = "hybrid.moe"


def read(ctx):
    spans = ctx.extra.get("spans")
    t = ctx.trace
    if not spans or SPAN not in spans or t is None or not t.jobs \
            or t.busy_s <= 0 or not spans[SPAN]["count"]:
        return None
    return 1e3 * spans[SPAN]["device_s"] / t.jobs
