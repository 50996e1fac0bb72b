"""job_ms: the measured window's host milliseconds over the whole jobs it
completed (every job, so a stall inside the window shows)."""


def read(ctx):
    if not ctx.jobs or ctx.window_s is None:
        return None
    return 1e3 * ctx.window_s / ctx.jobs
