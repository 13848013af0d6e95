"""Mean device time of one call of the classifier callable the attack gets
(crop, resize, normalise, forward), between CUDA events (the traced run,
outside the profiled stretch)."""


def read(ctx):
    ms = ctx.get("logits_ms") or []
    return sum(ms) / len(ms) if ms else None
