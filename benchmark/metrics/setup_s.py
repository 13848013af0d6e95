"""Set-up time: process start to the first timed iteration (imports,
kernel library load, inputs, weights, warm-up), on the host clock."""


def read(ctx):
    return ctx.get("setup_s")
