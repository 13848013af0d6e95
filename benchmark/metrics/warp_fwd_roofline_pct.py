"""The fixed-grid warp forward kernel's share of its roofline: the least
bytes the warp must move (``counts/warp_bytes.py``, from the grid and the
mask) at HBM bandwidth, over the kernel's mean device time in the trace."""

from benchmark.harness import kernel_mean_s

KERNEL = "fixed_warp_fwd_kernel"


def read(ctx):
    t = kernel_mean_s(ctx.get("trace"), KERNEL)
    if t is None or "warp_bytes" not in ctx:
        return None
    least = ctx["warp_bytes"]["fwd"] / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least / t
