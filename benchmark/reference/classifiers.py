"""The classify pipeline SPAA attacks through, in plain PyTorch: centre
crop, 'area' resize (adaptive average pooling) to the net's input,
ImageNet normalisation, the net's raw logits. The nets are found by name
in ``benchmark/reference/nets/<name>.py`` (``shapes()``, ``forward(p,
x)``, ``INPUT_HW``). Also the seeded weight draw that both sides take.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def net(name: str):
    return importlib.import_module(f"benchmark.reference.nets.{name}")


def draw_weights(name: str, seed: int, device, dtype=torch.float32) -> dict:
    """Seeded random weights of net ``name`` in one draw on ``device``:
    convolution kernels He-normal (std sqrt(2 / fan_in)), linear weights
    LeCun-normal (std sqrt(1 / fan_in)), biases 0, BatchNorm the identity
    (weight 1, bias 0, mean 0, variance 1)."""
    shapes = net(name).shapes()
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    mats = [k for k, v in shapes.items() if len(v) >= 2]
    sizes = [int(torch.Size(shapes[k]).numel()) for k in mats]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out = {}
    for k, chunk in zip(mats, torch.split(flat, sizes)):
        shp = shapes[k]
        gain = 2.0 if len(shp) == 4 else 1.0
        fan_in = int(torch.Size(shp[1:]).numel())
        out[k] = chunk.view(shp).mul_((gain / fan_in) ** 0.5)
    for k, shp in shapes.items():
        if k not in out:
            scale = k.endswith("running_var") or (
                k.endswith(".weight") and f"{k[:-7]}.running_var" in shapes)
            out[k] = torch.full(shp, 1.0 if scale else 0.0, device=device,
                                dtype=dtype)
    return out


def logits(name: str, p, im, crop_hw):
    """Raw logits of NHWC images in [0, 1]."""
    x = im.permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    i = int(round((h - crop_hw[0]) / 2.0))
    j = int(round((w - crop_hw[1]) / 2.0))
    x = x[..., i:i + crop_hw[0], j:j + crop_hw[1]]
    m = net(name)
    x = F.adaptive_avg_pool2d(x, m.INPUT_HW)
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return m.forward(p, (x - mean[:, None, None]) / std[:, None, None])
