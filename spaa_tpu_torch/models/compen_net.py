"""CompenNet (photometric compensation) and CompenNet++ (warp, then
compensate): counterpart of ``spaa_tpu/models/compen_net.py``, reference
``models.py:11-94,188-212``.

CompenNet is the inverse of ShadingNet: from the desired camera image and
the surface image it infers the projector input. Its skeleton is
ShadingNetSPAA's, with these differences (kept as the reference has them):
  - the surface branch takes 3 channels (no rough render);
  - transConv1 is kernel 2, stride 2, without output padding;
  - skipConv1's three convolutions are all 3x3 (ShadingNet's first is 1x1);
  - skipConv3 is 1x1 (ShadingNet's is 3x3);
  - the skip ``res1`` is computed from x itself (ShadingNet: from s);
  - the output is ``min(relu(conv6 + res1), 1)``.

Tensors are NHWC at the calls (x [N, H, W, 3], s [1 or N, H, W, 3]) and
NCHW inside; :class:`SurfaceFeatures` holds NCHW tensors. Module names are
``spaa_tpu``'s flax names, so the parameter bridge (``weights.py``) and the
initial draw (``models.init``) need no renaming.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spaa_tpu_torch.models.init import draw_spaa_tpu_init
from spaa_tpu_torch.models.shading_net import SurfaceFeatures
from spaa_tpu_torch.models.warping_net import WarpingNet


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class CompenNet(nn.Module):

    model_name = "CompenNet"

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3, 2, 1)
        self.conv2 = nn.Conv2d(32, 64, 3, 2, 1)
        self.conv3 = nn.Conv2d(64, 128, 3, 1, 1)
        self.conv4 = nn.Conv2d(128, 256, 3, 1, 1)
        self.conv5 = nn.Conv2d(256, 128, 3, 1, 1)
        self.conv1_s = nn.Conv2d(3, 32, 3, 2, 1)
        self.conv2_s = nn.Conv2d(32, 64, 3, 2, 1)
        self.conv3_s = nn.Conv2d(64, 128, 3, 1, 1)
        self.conv4_s = nn.Conv2d(128, 256, 3, 1, 1)
        self.transConv1 = nn.ConvTranspose2d(128, 64, 2, 2, 0)
        self.transConv2 = nn.ConvTranspose2d(64, 32, 2, 2, 0)
        self.conv6 = nn.Conv2d(32, 3, 3, 1, 1)
        self.skipConv1_0 = nn.Conv2d(3, 3, 3, 1, 1)
        self.skipConv1_2 = nn.Conv2d(3, 3, 3, 1, 1)
        self.skipConv1_4 = nn.Conv2d(3, 3, 3, 1, 1)
        self.skipConv2 = nn.Conv2d(32, 64, 1, 1, 0)
        self.skipConv3 = nn.Conv2d(64, 128, 1, 1, 0)

    def surface_features(self, s: torch.Tensor) -> SurfaceFeatures:
        """The surface branch of NHWC ``s`` (ref ``simplify``,
        ``models.py:62-71``)."""
        r1 = F.relu(self.conv1_s(_nchw(s)))
        r2 = F.relu(self.conv2_s(r1))
        r3 = F.relu(self.conv3_s(r2))
        r4 = F.relu(self.conv4_s(r3))
        return SurfaceFeatures(r1, r2, r3, r4)

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                surface_feats: Optional[SurfaceFeatures] = None):
        """x: desired camera image, s: surface image (NHWC); with
        ``surface_feats`` s is not read. Ref ``models.py:74-94``."""
        x = _nchw(x)
        res1 = F.relu(self.skipConv1_0(x))
        res1 = F.relu(self.skipConv1_2(res1))
        res1 = F.relu(self.skipConv1_4(res1))
        sf = self.surface_features(s) if surface_feats is None \
            else surface_feats
        h = F.relu(self.conv1(x) + sf.res1)
        res2 = self.skipConv2(h)
        h = F.relu(self.conv2(h) + sf.res2)
        res3 = self.skipConv3(h)
        h = F.relu(self.conv3(h) + sf.res3)
        h = F.relu(self.conv4(h) + sf.res4)
        h = F.relu(self.conv5(h) + res3)
        h = F.relu(self.transConv1(h) + res2)
        h = F.relu(self.transConv2(h))
        h = torch.clamp(F.relu(self.conv6(h) + res1), max=1.0)
        return h.permute(0, 2, 3, 1)

    def init_weights(self, rng_key) -> "CompenNet":
        """``spaa_tpu``'s initial weights for the root key ``rng_key``
        (``models.init.draw_spaa_tpu_init``)."""
        return draw_spaa_tpu_init(self, rng_key)


class CompenNetPlusplus(nn.Module):
    """WarpingNet then CompenNet: the desired camera image and the surface
    are both warped to the projector's ``out_size`` (H, W) with one grid,
    then compensated (ref ``models.py:188-212``)."""

    model_name = "CompenNet++"

    def __init__(self, out_size: Tuple[int, int] = (256, 256),
                 with_refine: bool = True):
        super().__init__()
        self.warping_net = WarpingNet(out_size, with_refine=with_refine)
        self.compen_net = CompenNet()

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                fine_grid: Optional[torch.Tensor] = None,
                surface_feats: Optional[SurfaceFeatures] = None):
        """x [N, Hc, Wc, 3], s [1 or N, Hc, Wc, 3] -> [N, Hp, Wp, 3]. With
        ``surface_feats`` (from :meth:`simplify`) s is not read. Ref
        ``models.py:204-212``: the grid is built once for both images."""
        if fine_grid is None:
            fine_grid = self.warping_net.fine_grid()
        xw = self.warping_net(x, fine_grid)
        if surface_feats is None:
            return self.compen_net(xw, self.warping_net(s, fine_grid))
        return self.compen_net(xw, s, surface_feats=surface_feats)

    def simplify(self, s: torch.Tensor):
        """``(fine_grid, surface_feats)`` for a fixed scene s [1, Hc, Wc, 3]
        (ref ``models.py:199-201``)."""
        fine_grid = self.warping_net.simplify()
        sw = self.warping_net(s, fine_grid)
        return fine_grid, self.compen_net.surface_features(sw)

    def init_weights(self, rng_key) -> "CompenNetPlusplus":
        """``spaa_tpu``'s initial weights for the root key ``rng_key``
        (``models.init.draw_spaa_tpu_init``)."""
        return draw_spaa_tpu_init(self, rng_key)
