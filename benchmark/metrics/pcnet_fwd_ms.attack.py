"""Mean device time of one call of the PCNet callable the attack gets,
between CUDA events recorded before and after it (the traced run, outside
the profiled stretch)."""


def read(ctx):
    ms = ctx.get("pcnet_ms") or []
    return sum(ms) / len(ms) if ms else None
