"""Plain PyTorch CompenNet++ (Huang & Ling, CVPR 2019; the published
``models.py`` ``CompenNet`` and ``CompenNetPlusplus``), written as
functions of a parameter dict with PyTorch's module names
(``warping_net.theta``, ``compen_net.conv1.weight``, ...).

WarpingNet's grid is ``benchmark.reference.pcnet.warp_grid`` (affine,
thin-plate spline, grid refiner, clamp), computed at the projector's size;
the desired camera image and the surface are both warped with it by
``F.grid_sample`` (bilinear, ``align_corners=True``, zeros padding), then
CompenNet infers the projector input. Tensors at the interface are NHWC.
"""

from __future__ import annotations

import torch.nn.functional as F

from benchmark.reference.pcnet import _conv, _tconv

# (out, in, kernel) of CompenNet's convolutions; (in, out, kernel) of its
# transposed ones and of the grid refiner's
CONVS = {"conv1": (32, 3, 3), "conv2": (64, 32, 3), "conv3": (128, 64, 3),
         "conv4": (256, 128, 3), "conv5": (128, 256, 3),
         "conv1_s": (32, 3, 3), "conv2_s": (64, 32, 3),
         "conv3_s": (128, 64, 3), "conv4_s": (256, 128, 3),
         "conv6": (3, 32, 3), "skipConv1_0": (3, 3, 3),
         "skipConv1_2": (3, 3, 3), "skipConv1_4": (3, 3, 3),
         "skipConv2": (64, 32, 1), "skipConv3": (128, 64, 1)}
TCONVS = {"transConv1": (128, 64, 2), "transConv2": (64, 32, 2)}
REFINE = {"conv1": ((32, 2, 3), False), "conv2": ((64, 32, 3), False),
          "tconv1": ((64, 32, 2), True), "tconv2": ((32, 2, 2), True)}


def shapes(grid_shape=(6, 6)) -> dict:
    """Every parameter's shape, by name."""
    out = {"warping_net.affine_mat": (1, 2, 3),
           "warping_net.theta": (1, grid_shape[0] * grid_shape[1] + 2, 2)}
    for name, ((a, b, k), transposed) in REFINE.items():
        pre = f"warping_net.grid_refine_net.{name}"
        out[pre + ".weight"] = (a, b, k, k)
        out[pre + ".bias"] = (b if transposed else a,)
    for name, (co, ci, k) in CONVS.items():
        out[f"compen_net.{name}.weight"] = (co, ci, k, k)
        out[f"compen_net.{name}.bias"] = (co,)
    for name, (ci, co, k) in TCONVS.items():
        out[f"compen_net.{name}.weight"] = (ci, co, k, k)
        out[f"compen_net.{name}.bias"] = (co,)
    return out


def compennet(p, x, s):
    """CompenNet on the warped desired image x [N, 3, H, W] and the warped
    surface s [1 or N, 3, H, W] -> the projector input [N, 3, H, W]."""
    q = "compen_net."
    res1 = F.relu(_conv(p, q + "skipConv1_0", x, 1, 1))
    res1 = F.relu(_conv(p, q + "skipConv1_2", res1, 1, 1))
    res1 = F.relu(_conv(p, q + "skipConv1_4", res1, 1, 1))
    r1 = F.relu(_conv(p, q + "conv1_s", s, 2, 1))
    r2 = F.relu(_conv(p, q + "conv2_s", r1, 2, 1))
    r3 = F.relu(_conv(p, q + "conv3_s", r2, 1, 1))
    r4 = F.relu(_conv(p, q + "conv4_s", r3, 1, 1))
    h = F.relu(_conv(p, q + "conv1", x, 2, 1) + r1)
    res2 = _conv(p, q + "skipConv2", h)
    h = F.relu(_conv(p, q + "conv2", h, 2, 1) + r2)
    res3 = _conv(p, q + "skipConv3", h)
    h = F.relu(_conv(p, q + "conv3", h, 1, 1) + r3)
    h = F.relu(_conv(p, q + "conv4", h, 1, 1) + r4)
    h = F.relu(_conv(p, q + "conv5", h, 1, 1) + res3)
    h = F.relu(_tconv(p, q + "transConv1", h, 2) + res2)
    h = F.relu(_tconv(p, q + "transConv2", h, 2))
    return (F.relu(_conv(p, q + "conv6", h, 1, 1) + res1)).clamp(max=1.0)


def _warp(im, grid):
    x = im.permute(0, 3, 1, 2)
    return F.grid_sample(x, grid.expand(x.shape[0], -1, -1, -1),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def compennet_pp(p, grid, cam, scene):
    """CompenNet++: cam [N, Hc, Wc, 3], scene [1 or N, Hc, Wc, 3], grid
    [1, Hp, Wp, 2] (``warp_grid(p, (Hp, Wp))``) -> projector input
    [N, Hp, Wp, 3]."""
    return compennet(p, _warp(cam, grid), _warp(scene, grid)).permute(
        0, 2, 3, 1)

