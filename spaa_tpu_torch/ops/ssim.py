"""Gaussian-window SSIM, NHWC (counterpart of ``spaa_tpu/ops/ssim.py``,
reference ``pytorch_ssim/__init__.py:9-107``): 11x11 Gaussian window,
sigma 1.5, replicate padding, per-channel (depthwise) filtering run as two
separable 1-D convolutions, C1 = 0.01^2, C2 = 0.03^2."""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
                  for x in range(window_size)], np.float32)
    return g / g.sum()


def _depthwise_blur(x: torch.Tensor, window_size: int,
                    sigma: float) -> torch.Tensor:
    """Separable depthwise Gaussian of a pre-padded NCHW image, 'valid'
    (each spatial dim shrinks by window_size - 1)."""
    c = x.shape[1]
    g = torch.from_numpy(_gaussian_1d(window_size, sigma)).to(x.device,
                                                              x.dtype)
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map [N, H, W, C] of two NHWC images."""
    pad = window_size // 2
    p1 = F.pad(img1.permute(0, 3, 1, 2), (pad,) * 4, mode="replicate")
    p2 = F.pad(img2.permute(0, 3, 1, 2), (pad,) * 4, mode="replicate")
    mu1 = _depthwise_blur(p1, window_size, sigma)
    mu2 = _depthwise_blur(p2, window_size, sigma)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(p1 * p1, window_size, sigma) - mu1_sq
    sigma2_sq = _depthwise_blur(p2 * p2, window_size, sigma) - mu2_sq
    sigma12 = _depthwise_blur(p1 * p2, window_size, sigma) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return m.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True, mask: Optional[torch.Tensor] = None,
         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar SSIM (``size_average``) or per-sample SSIM [N]; ``mask`` and
    ``weights`` weight the pixels (ref lines 54-67)."""
    m = ssim_map(img1, img2, window_size)
    if weights is not None:
        m = m * weights
    if size_average:
        if mask is not None:
            return torch.sum(m * mask) / torch.clamp(
                torch.sum(mask * torch.ones_like(m)), min=1e-8)
        return torch.mean(m)
    if mask is not None:
        m = m * mask
    return torch.mean(m, dim=(1, 2, 3))
