"""ShadingNetSPAA: PCNet's photometric CNN (counterpart of
``spaa_tpu/models/shading_net.py``, reference ``models.py:214-303``).

NCHW inside. Channel plan (the reference's):
  backbone:  3->32(s2)->64(s2)->128->256->128, up 128->64(s2)->32(s2)->3
  surface:   6 (3 without rough)->32(s2)->64(s2)->128->256
  skips:     skipConv1 3->3->3->3 (1x1, 3x3, 3x3), skipConv2 32->64 1x1,
             skipConv3 64->128 3x3
The scene may stay a single image [1, 3, H, W] while x is [B, ...]: the
scene-only skipConv1 chain then runs once and broadcasts at the final add.
The stride-1 3x3 layers run through ``ops.conv.conv3x3_s1`` with their own
parameters, which on the card routes each forward by shape.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spaa_tpu_torch.ops import conv as conv_ops


class SurfaceFeatures(NamedTuple):
    res1: torch.Tensor
    res2: torch.Tensor
    res3: torch.Tensor
    res4: torch.Tensor


def _c3(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` for a stride-1, pad-1 3x3 layer."""
    return conv_ops.conv3x3_s1(x, layer.weight, layer.bias)


class ShadingNetSPAA(nn.Module):

    def __init__(self, use_rough: bool = True):
        super().__init__()
        self.use_rough = use_rough
        self.conv1 = nn.Conv2d(3, 32, 3, 2, 1)
        self.conv2 = nn.Conv2d(32, 64, 3, 2, 1)
        self.conv3 = nn.Conv2d(64, 128, 3, 1, 1)
        self.conv4 = nn.Conv2d(128, 256, 3, 1, 1)
        self.conv5 = nn.Conv2d(256, 128, 3, 1, 1)
        cs = 6 if use_rough else 3
        self.conv1_s = nn.Conv2d(cs, 32, 3, 2, 1)
        self.conv2_s = nn.Conv2d(32, 64, 3, 2, 1)
        self.conv3_s = nn.Conv2d(64, 128, 3, 1, 1)
        self.conv4_s = nn.Conv2d(128, 256, 3, 1, 1)
        self.transConv1 = nn.ConvTranspose2d(128, 64, 3, 2, 1, 1)
        self.transConv2 = nn.ConvTranspose2d(64, 32, 2, 2, 0)
        self.conv6 = nn.Conv2d(32, 3, 3, 1, 1)
        self.skipConv1_0 = nn.Conv2d(3, 3, 1, 1, 0)
        self.skipConv1_2 = nn.Conv2d(3, 3, 3, 1, 1)
        self.skipConv1_4 = nn.Conv2d(3, 3, 3, 1, 1)
        self.skipConv2 = nn.Conv2d(32, 64, 1, 1, 0)
        self.skipConv3 = nn.Conv2d(64, 128, 3, 1, 1)

    def surface_features(self, *surfaces: torch.Tensor) -> SurfaceFeatures:
        """Encode the conditioning surfaces (s[, rough]) once (ref
        ``simplify``, ``models.py:268-277``); surfaces are broadcast to a
        common batch before the channel concat."""
        b = max(t.shape[0] for t in surfaces)
        s = torch.cat([t.expand(b, *t.shape[1:]) for t in surfaces], dim=1)
        r1 = F.relu(self.conv1_s(s))
        r2 = F.relu(self.conv2_s(r1))
        r3 = F.relu(_c3(self.conv3_s, r2))
        r4 = F.relu(_c3(self.conv4_s, r3))
        return SurfaceFeatures(r1, r2, r3, r4)

    def forward(self, x: torch.Tensor, *surfaces: torch.Tensor,
                surface_feats: Optional[SurfaceFeatures] = None):
        """x: warped projector image; surfaces: (s,) or (s, rough)."""
        res1 = F.relu(self.skipConv1_0(surfaces[0]))
        res1 = F.relu(_c3(self.skipConv1_2, res1))
        res1 = F.relu(_c3(self.skipConv1_4, res1))
        sf = (self.surface_features(*surfaces) if surface_feats is None
              else surface_feats)
        h = F.relu(self.conv1(x) + sf.res1)
        res2 = self.skipConv2(h)
        h = F.relu(self.conv2(h) + sf.res2)
        res3 = _c3(self.skipConv3, h)
        h = F.relu(_c3(self.conv3, h) + sf.res3)
        h = F.relu(_c3(self.conv4, h) + sf.res4)
        h = F.relu(_c3(self.conv5, h) + res3)
        h = F.relu(self.transConv1(h) + res2)
        h = F.relu(self.transConv2(h))
        return torch.clamp(F.relu(_c3(self.conv6, h) + res1), max=1.0)
