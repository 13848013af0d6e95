"""Seconds to train one setup's PCNet: the window's wall time per training
iteration (validations included in proportion) times the default run's
iterations, host clock."""


def read(ctx):
    w = ctx.get("window", {})
    if ctx.get("kind") != "train" or not w.get("iters"):
        return None
    return w["wall_s"] / w["iters"] * w["iters_per_setup"]
