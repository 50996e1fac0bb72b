"""setup_s: host seconds from the process's start to the first timed job
(imports, kernel build or load, the driver's set-up, the warm-up)."""


def read(ctx):
    return ctx.setup_s
