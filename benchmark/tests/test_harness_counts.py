"""The FLOP counter and the warp byte counter against published and
hand counts."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.counts import flops as FC
from benchmark.counts.warp_bytes import taps, warp_bytes
from benchmark.reference import classifiers as RC


def _meta_params(name):
    return {k: torch.empty(v, device="meta")
            for k, v in RC.net(name).shapes().items()}


@pytest.mark.parametrize("name,published", [("resnet18", 1.8e9),
                                            ("vgg16", 15.5e9)])
def test_classifier_forward_macs_as_published(name, published):
    # He et al. Table 1 (ResNet-18: 1.8 G multiply-adds at 224x224);
    # VGG-16 configuration D: 15.5 G
    x = torch.empty(1, 3, 224, 224, device="meta")
    macs = FC.count(RC.net(name).forward, _meta_params(name), x)
    assert abs(macs.forward / published - 1) < 0.01
    assert macs.input_grad == 0 and macs.weight_grad == 0


def test_layer_formulas_by_hand():
    x = torch.empty(2, 3, 8, 10, device="meta", requires_grad=True)
    w = torch.empty(4, 3, 3, 3, device="meta")
    m = FC.count(lambda: F.conv2d(x, w, None, 2, 1))
    # output 2 x 4 x 4 x 5, each 3 x 3 x 3 multiply-adds
    assert m.forward == 2 * 4 * 4 * 5 * 27 == m.input_grad
    assert m.weight_grad == 0
    wt = torch.empty(3, 5, 2, 2, device="meta", requires_grad=True)
    m = FC.count(lambda: F.conv_transpose2d(x, wt, None, 2))
    # each of 2 x 3 x 8 x 10 inputs scatters into 5 x 2 x 2 outputs
    assert m.forward == 2 * 3 * 80 * 20 == m.input_grad == m.weight_grad
    wl = torch.empty(7, 10, device="meta")
    m = FC.count(lambda: F.linear(x, wl))
    assert m.forward == 2 * 3 * 8 * 10 * 7
    assert m.flops("input") == 4 * m.forward
    assert m.flops("full") == 4 * m.forward
    assert FC.Macs(3, 5, 7).flops("none") == 6
    assert FC.Macs(3, 5, 7).flops("full") == 30


def test_warp_bytes_by_hand():
    # source 5 x 5; align_corners: pixel x = (g + 1) / 2 * 4, so
    # g = x / 2 - 1 is exact; output 1 x 4
    src_hw = (5, 5)

    def g(px):
        return px / 2.0 - 1.0

    grid = np.array([[[g(1), g(1)],          # on a pixel: tap 6
                      [g(1.5), g(2)],        # between two: taps 11, 12
                      [g(2.5), g(2.5)],      # centre of four: 12 13 17 18
                      [g(4.5), g(0)]]],      # half outside: tap 4 only
                    np.float32)
    out_px, src_px = taps(grid, src_hw)
    assert sorted(set(src_px.tolist())) == [4, 6, 11, 12, 13, 17, 18]
    assert sorted(set(out_px.tolist())) == [0, 1, 2, 3]
    assert len(src_px) == 1 + 2 + 4 + 1
    b, c = 2, 3
    per = b * c * 4
    got = warp_bytes(grid, src_hw, np.ones((1, 4)), b, c)
    assert got["fwd"] == per * (7 + 4) + 8 * 4
    assert got["bwd"] == per * (4 + 25) + 8 * 4
    # a masked output pixel drops its taps on both passes
    mask = np.array([[1, 1, 0, 1]])
    got = warp_bytes(grid, src_hw, mask, b, c)
    assert got["fwd"] == per * (4 + 4) + 8 * 4
    assert got["bwd"] == per * (3 + 25) + 8 * 4


def test_pcnet_pullback_skips_scene_only_layers():
    from benchmark.reference import pcnet as RP
    p = {}
    for name, (co, ci, k) in {
            "skipConv1_0": (3, 3, 1), "skipConv1_2": (3, 3, 3),
            "skipConv1_4": (3, 3, 3), "conv1_s": (32, 6, 3),
            "conv2_s": (64, 32, 3), "conv3_s": (128, 64, 3),
            "conv4_s": (256, 128, 3), "conv1": (32, 3, 3),
            "conv2": (64, 32, 3), "conv3": (128, 64, 3),
            "conv4": (256, 128, 3), "conv5": (128, 256, 3),
            "skipConv2": (64, 32, 1), "skipConv3": (128, 64, 3),
            "conv6": (3, 32, 3)}.items():
        p[f"shading_net.{name}.weight"] = torch.empty(co, ci, k, k,
                                                      device="meta")
        p[f"shading_net.{name}.bias"] = torch.empty(co, device="meta")
    for name, (ci, co, k) in {"transConv1": (128, 64, 3),
                              "transConv2": (64, 32, 2)}.items():
        p[f"shading_net.{name}.weight"] = torch.empty(ci, co, k, k,
                                                      device="meta")
        p[f"shading_net.{name}.bias"] = torch.empty(co, device="meta")
    prj = torch.empty(2, 16, 16, 3, device="meta", requires_grad=True)
    m = FC.count(RP.pcnet, p, torch.empty(1, 8, 12, 2, device="meta"),
                 torch.empty(8, 12, device="meta"),
                 torch.empty(1, 8, 12, 3, device="meta"), prj)
    scene_only = 8 * 12 * 3 * (3 * 1 + 3 * 9 + 3 * 9)
    assert m.forward - m.input_grad == scene_only
