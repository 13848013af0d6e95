"""VGG-16, configuration D without BatchNorm (Simonyan & Zisserman,
arXiv:1409.1556), inference, on a torchvision-named parameter dict
(``features.<i>``, ``classifier.<i>``; dropout is the identity)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

INPUT_HW = (224, 224)
_D = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
      512, 512, 512, "M"]


def shapes() -> dict:
    s, cin, idx = {}, 3, 0
    for v in _D:
        if v == "M":
            idx += 1
            continue
        s[f"features.{idx}.weight"] = (v, cin, 3, 3)
        s[f"features.{idx}.bias"] = (v,)
        cin, idx = v, idx + 2
    for i, (a, b) in zip((0, 3, 6), ((25088, 4096), (4096, 4096),
                                     (4096, 1000))):
        s[f"classifier.{i}.weight"], s[f"classifier.{i}.bias"] = (b, a), (b,)
    return s


def forward(p, x):
    idx = 0
    for v in _D:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            idx += 1
        else:
            x = F.relu(F.conv2d(x, p[f"features.{idx}.weight"],
                                p[f"features.{idx}.bias"], 1, 1))
            idx += 2
    x = torch.flatten(x, 1)
    x = F.relu(F.linear(x, p["classifier.0.weight"], p["classifier.0.bias"]))
    x = F.relu(F.linear(x, p["classifier.3.weight"], p["classifier.3.bias"]))
    return F.linear(x, p["classifier.6.weight"], p["classifier.6.bias"])
