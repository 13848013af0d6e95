"""PCNet: the differentiable project-and-capture simulator (counterpart of
``spaa_tpu/models/pcnet.py``, reference ``models.py:305-345``).

Warp the projector image to camera space, multiply by the direct-light
mask, then relight with ShadingNetSPAA conditioned on (scene, rough render
= warped * scene). :meth:`PCNet.simplify_cache` bakes the sampling grid
(and, without the rough channel, the surface features).

Tensors: x is NHWC at the call, like ``spaa_tpu``'s, and the result is an
NHWC view of the NCHW tensor the CNN produces; scene [1 or N, H, W, 3] and
mask [H, W, 1] are NHWC too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from spaa_tpu_torch.models.init import draw_spaa_tpu_init
from spaa_tpu_torch.models.shading_net import ShadingNetSPAA, SurfaceFeatures
from spaa_tpu_torch.models.warping_net import WarpingNet


class PCNetCache(NamedTuple):
    """Constants precomputed for a fixed scene (the ``simplify`` state)."""
    fine_grid: Optional[torch.Tensor]           # [1, H, W, 2]
    surface_feats: Optional[SurfaceFeatures]    # None if not cached


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class PCNet(nn.Module):
    """``out_size`` is the camera image (H, W); ``use_mask``/``use_rough``
    toggle the direct-light mask and the rough-render channel."""

    def __init__(self, out_size: Tuple[int, int] = (240, 320),
                 grid_shape: Tuple[int, int] = (6, 6),
                 with_refine: bool = True, use_mask: bool = True,
                 use_rough: bool = True):
        super().__init__()
        self.use_mask = use_mask
        self.use_rough = use_rough
        self.warping_net = WarpingNet(out_size, grid_shape, with_refine)
        self.shading_net = ShadingNetSPAA(use_rough=use_rough)

    @property
    def model_name(self) -> str:
        name = "PCNet"
        if not self.use_mask:
            name += "_no_mask"
        if not self.use_rough:
            name += "_no_rough"
        return name

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                cache: Optional[PCNetCache] = None,
                warped: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N, Hp, Wp, 3], s [1 or N, H, W, 3], mask [H, W, 1];
        ``warped``: the already-warped projector image (NHWC), e.g. from
        the fixed-grid kernel, which skips WarpingNet."""
        if warped is None:
            warped = self.warping_net(
                x, cache.fine_grid if cache is not None else None)
        xw = _nchw(warped)
        if self.use_mask and mask is not None:
            xw = xw * mask.reshape(mask.shape[-3], mask.shape[-2])
        s = _nchw(s)
        sf = cache.surface_feats if cache is not None else None
        if self.use_rough:
            out = self.shading_net(xw, s, xw * s, surface_feats=sf)
        else:
            out = self.shading_net(xw, s, surface_feats=sf)
        return out.permute(0, 2, 3, 1)

    def init_weights(self, rng_key) -> "PCNet":
        """``spaa_tpu``'s initial weights for the root key ``rng_key``
        (``models.init.draw_spaa_tpu_init``)."""
        return draw_spaa_tpu_init(self, rng_key)

    def simplify_cache(self, s: torch.Tensor) -> PCNetCache:
        """Bake the grid (and the surface features when ``use_rough`` is
        off, the only case they do not depend on x) for scene s [1,H,W,3]."""
        sf = None
        if not self.use_rough:
            sf = self.shading_net.surface_features(_nchw(s))
        return PCNetCache(self.warping_net.simplify(), sf)
