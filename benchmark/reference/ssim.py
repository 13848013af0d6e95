"""Plain PyTorch SSIM as the published ``pytorch_ssim`` computes it for
training: an 11x11 Gaussian window of sigma 1.5 applied per channel (as
its two 1-D factors, the least work), replicate padding, C1 = 0.01^2,
C2 = 0.03^2, mean over every pixel and channel. NHWC in."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def ssim(a, b, window: int = 11, sigma: float = 1.5):
    g = torch.tensor([math.exp(-((x - window // 2) ** 2) / (2 * sigma ** 2))
                      for x in range(window)], dtype=a.dtype, device=a.device)
    g = g / g.sum()
    c = a.shape[-1]
    gv = g.view(1, 1, -1, 1).expand(c, 1, window, 1)
    gh = g.view(1, 1, 1, -1).expand(c, 1, 1, window)
    pad = window // 2

    def blur(x):
        x = F.pad(x, (pad,) * 4, mode="replicate")
        return F.conv2d(F.conv2d(x, gv, groups=c), gh, groups=c)

    x, y = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    mx, my = blur(x), blur(y)
    sxx = blur(x * x) - mx * mx
    syy = blur(y * y) - my * my
    sxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mx * my + c1) * (2 * sxy + c2))
                      / ((mx * mx + my * my + c1) * (sxx + syy + c2)))
