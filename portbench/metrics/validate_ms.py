"""validate_ms: host milliseconds of ``validate(backend="cuda")`` (the
driver's ``validate`` span)."""


def read(ctx):
    s = ctx.spans.get("validate")
    return None if s is None else 1e3 * s
