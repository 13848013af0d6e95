"""The training iteration's model FLOPs (PCNet forward with its warp grid,
the full backward, SSIM's window convolutions, counted from the layer
shapes) per mean iteration time of the traced run outside its profiled
stretch, as a share of the chip's dense bf16 tensor peak."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("iter_s"):
        return None
    peak = ctx["peaks"]["bf16_dense_flops_per_s"]
    return 100.0 * ctx["flops_per_iter"] / ctx["iter_s"] / peak
