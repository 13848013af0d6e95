"""The fixed-grid warp backward kernel's share of its roofline: the least
bytes of the backward (``counts/warp_bytes.py``) at HBM bandwidth, over
the kernel's mean device time in the trace."""

from benchmark.harness import kernel_mean_s

KERNEL = "fixed_warp_bwd_kernel"


def read(ctx):
    t = kernel_mean_s(ctx.get("trace"), KERNEL)
    if t is None or "warp_bytes" not in ctx:
        return None
    least = ctx["warp_bytes"]["bwd"] / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least / t
