"""decode_step_ms: host milliseconds of one decode step, the mean length of
the program's ``serve.decode_step`` spans in the traced requests (a step
ends with its tokens on the host, so it holds the device's work)."""

SPAN = "serve.decode_step"


def read(ctx):
    spans = ctx.extra.get("spans")
    if not spans or SPAN not in spans or not spans[SPAN]["count"]:
        return None
    return 1e3 * spans[SPAN]["host_s"] / spans[SPAN]["count"]
