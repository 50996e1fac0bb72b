"""analysis_ms: host milliseconds of the analysis, from ``analyze`` through
``compile`` (the driver's ``analysis`` span)."""


def read(ctx):
    s = ctx.spans.get("analysis")
    return None if s is None else 1e3 * s
