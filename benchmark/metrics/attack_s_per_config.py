"""Seconds per (stealth loss, d_thr) config of a sweep: the window's wall
time over the configs its SPAA iterations amount to (iterations x configs
per sweep / iterations per sweep), host clock."""


def read(ctx):
    w = ctx.get("window", {})
    if ctx.get("kind") != "attack" or not w.get("iters"):
        return None
    configs = w["iters"] * w["configs_per_sweep"] / w["iters_per_sweep"]
    return w["wall_s"] / configs
