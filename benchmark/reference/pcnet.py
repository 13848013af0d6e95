"""Plain PyTorch PCNet (SPAA, Huang & Ling, IEEE VR 2022; the published
``models.py`` PCNet with WarpingNet and ShadingNetSPAA), written as
functions of a parameter dict with PyTorch's module names
(``warping_net.theta``, ``shading_net.conv1.weight``, ...).

The warp is ``F.grid_sample`` (bilinear, ``align_corners=True``, zeros
padding) over the grid WarpingNet computes from its parameters: affine,
thin-plate spline over a 6x6 control grid, CNN refinement, clamp. Tensors
at the interface are NHWC, as the attack passes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv(p, name, x, stride=1, pad=0):
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride, pad)


def _tconv(p, name, x, stride, pad=0, out_pad=0):
    return F.conv_transpose2d(x, p[name + ".weight"], p[name + ".bias"],
                              stride, pad, out_pad)


def _tps_grid(theta, h: int, w: int, grid_shape=(6, 6)):
    """The TPS sampling grid [1, h, w, 2] in [-1, 1] of the reduced theta
    [1, T + 2, 2] (``pytorch_tps.py``): control points uniform on [0, 1]^2,
    radial basis d^2 log(d + 1e-6), the first weight minus the sum of the
    others."""
    dt, dev = theta.dtype, theta.device
    cy, cx = torch.meshgrid(torch.linspace(0, 1, grid_shape[0], dtype=dt,
                                           device=dev),
                            torch.linspace(0, 1, grid_shape[1], dtype=dt,
                                           device=dev), indexing="ij")
    ctrl = torch.stack([cx, cy], -1).reshape(-1, 2)
    gy, gx = torch.meshgrid(torch.linspace(0, 1, h, dtype=dt, device=dev),
                            torch.linspace(0, 1, w, dtype=dt, device=dev),
                            indexing="ij")
    xy = torch.stack([gx, gy], -1)                              # [h, w, 2]
    d = torch.sqrt(((xy[:, :, None, :] - ctrl) ** 2).sum(-1))   # [h, w, T]
    u = d * d * torch.log(d + 1e-6)
    wts = theta[0, :-3]
    wts = torch.cat([-wts.sum(0, keepdim=True), wts], 0)        # [T, 2]
    a = theta[0, -3:]                                           # [3, 2]
    homog = torch.cat([torch.ones_like(xy[..., :1]), xy], -1)   # (1, x, y)
    z = homog @ a + u @ wts
    return ((xy + z) * 2.0 - 1.0)[None]


def warp_grid(p, out_hw):
    """WarpingNet's fine grid [1, H, W, 2] (published ``models.py``
    ``WarpingNet``: the affine grid resampled by the TPS grid, plus the
    grid refiner's output, clamped to [-1, 1])."""
    h, w = out_hw
    aff = F.affine_grid(p["warping_net.affine_mat"], (1, 2, h, w),
                        align_corners=True)
    tps = _tps_grid(p["warping_net.theta"], h, w)
    g = F.grid_sample(aff.permute(0, 3, 1, 2), tps, mode="bilinear",
                      padding_mode="zeros", align_corners=True)   # [1,2,h,w]
    r = "warping_net.grid_refine_net."
    x = F.relu(_conv(p, r + "conv1", g, 2, 1))
    x = F.relu(_conv(p, r + "conv2", x, 2, 1))
    x = F.relu(_tconv(p, r + "tconv1", x, 2))
    x = F.leaky_relu(_tconv(p, r + "tconv2", x, 2), 0.1)
    return torch.clamp((g + x).permute(0, 2, 3, 1), -1.0, 1.0)


def shading(p, x, s):
    """ShadingNetSPAA on the warped, masked projector image x [N, 3, H, W]
    and the scene s [1, 3, H, W], with the rough render x * s."""
    q = "shading_net."
    res1 = F.relu(_conv(p, q + "skipConv1_0", s))
    res1 = F.relu(_conv(p, q + "skipConv1_2", res1, 1, 1))
    res1 = F.relu(_conv(p, q + "skipConv1_4", res1, 1, 1))
    surf = torch.cat([s.expand(x.shape[0], -1, -1, -1), x * s], 1)
    r1 = F.relu(_conv(p, q + "conv1_s", surf, 2, 1))
    r2 = F.relu(_conv(p, q + "conv2_s", r1, 2, 1))
    r3 = F.relu(_conv(p, q + "conv3_s", r2, 1, 1))
    r4 = F.relu(_conv(p, q + "conv4_s", r3, 1, 1))
    h = F.relu(_conv(p, q + "conv1", x, 2, 1) + r1)
    res2 = _conv(p, q + "skipConv2", h)
    h = F.relu(_conv(p, q + "conv2", h, 2, 1) + r2)
    res3 = _conv(p, q + "skipConv3", h, 1, 1)
    h = F.relu(_conv(p, q + "conv3", h, 1, 1) + r3)
    h = F.relu(_conv(p, q + "conv4", h, 1, 1) + r4)
    h = F.relu(_conv(p, q + "conv5", h, 1, 1) + res3)
    h = F.relu(_tconv(p, q + "transConv1", h, 2, 1, 1) + res2)
    h = F.relu(_tconv(p, q + "transConv2", h, 2))
    return torch.clamp(F.relu(_conv(p, q + "conv6", h, 1, 1) + res1), max=1.0)


def pcnet(p, grid, mask, scene, prj):
    """PCNet's forward: prj [N, Hp, Wp, 3] -> camera image [N, H, W, 3].
    grid [1, H, W, 2] (:func:`warp_grid`), mask [H, W] (0/1), scene
    [1, H, W, 3]."""
    x = prj.permute(0, 3, 1, 2)
    warped = F.grid_sample(x, grid.expand(x.shape[0], -1, -1, -1),
                           mode="bilinear", padding_mode="zeros",
                           align_corners=True) * mask
    return shading(p, warped, scene.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
