"""The least bytes a bilinear warp over a fixed grid must move, counted
from the grid and the direct-light mask alone (whatever tables an
implementation builds from them).

Forward (source [B, Hs, Ws, C] -> output [B, C, Ho, Wo], float32): each
source pixel that a non-zero tap of an unmasked output pixel touches, read
once; every output pixel written once; the grid at 8 bytes (two float32)
per output pixel. Backward: the same with input and output exchanged:
each output-space pixel that has a non-zero tap read once, every source
pixel written once, the grid again. Taps follow ``grid_sample``
(``align_corners=True``, zeros padding): the four neighbours of the
sample point, weights (1 - fx)(1 - fy) ..., a tap outside the image or of
weight 0 dropped.
"""

from __future__ import annotations

import numpy as np

F32 = 4


def taps(grid: np.ndarray, src_hw, mask=None):
    """(output flat index, source flat index) of every non-zero tap.
    grid [Ho, Wo, 2] (x, y) in [-1, 1]; mask [Ho, Wo] (0 drops the
    output pixel)."""
    h, w = src_hw
    x = (grid[..., 0].astype(np.float64) + 1.0) * 0.5 * (w - 1)
    y = (grid[..., 1].astype(np.float64) + 1.0) * 0.5 * (h - 1)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    keep_px = np.ones(x.shape, bool) if mask is None else \
        np.asarray(mask).reshape(x.shape) != 0
    outs, srcs = [], []
    out_flat = np.arange(x.size).reshape(x.shape)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xt, yt = x0 + dx, y0 + dy
            ok = ((wx * wy) != 0) & (xt >= 0) & (xt <= w - 1) & (yt >= 0) \
                & (yt <= h - 1) & keep_px
            outs.append(out_flat[ok])
            srcs.append((yt[ok] * w + xt[ok]).astype(np.int64))
    return np.concatenate(outs), np.concatenate(srcs)


def warp_bytes(grid: np.ndarray, src_hw, mask, batch: int,
               channels: int = 3) -> dict:
    """{'fwd': bytes, 'bwd': bytes} of one pass over ``batch`` images."""
    ho, wo = grid.shape[:2]
    out_px, src_px = taps(grid, src_hw, mask)
    per_px = batch * channels * F32
    grid_bytes = 8 * ho * wo
    n_src_read = int(np.unique(src_px).size)
    n_out_read = int(np.unique(out_px).size)
    return {"fwd": per_px * (n_src_read + ho * wo) + grid_bytes,
            "bwd": per_px * (n_out_read + src_hw[0] * src_hw[1])
            + grid_bytes}
