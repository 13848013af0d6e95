"""The device's idle share of the profiled stretch of SPAA sweeps: one
minus the union of kernel, copy and memset intervals over the stretch."""


def read(ctx):
    s = ctx.get("trace")
    if ctx.get("kind") != "attack" or not s or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
