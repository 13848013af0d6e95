"""The SPAA iteration's model FLOPs (PCNet forward and input pullback,
classifier forward and input gradient, counted from the layer shapes) per
mean iteration time of the traced run outside its profiled stretch, as a
share of the chip's dense bf16 tensor peak."""


def read(ctx):
    if ctx.get("kind") != "attack" or not ctx.get("iter_s"):
        return None
    peak = ctx["peaks"]["bf16_dense_flops_per_s"]
    return 100.0 * ctx["flops_per_iter"] / ctx["iter_s"] / peak
