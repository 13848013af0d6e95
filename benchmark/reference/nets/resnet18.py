"""ResNet-18 (He et al., arXiv:1512.03385, Table 1), inference, on a
torchvision-named parameter dict (BatchNorm with running statistics)."""

from __future__ import annotations

import torch.nn.functional as F

INPUT_HW = (224, 224)


def shapes() -> dict:
    s = {"conv1.weight": (64, 3, 7, 7)}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            s[f"{name}.{k}"] = (c,)

    bn("bn1", 64)
    cin = 64
    for i, c in enumerate((64, 128, 256, 512)):
        for b in range(2):
            t = f"layer{i + 1}.{b}"
            s[f"{t}.conv1.weight"] = (c, cin if b == 0 else c, 3, 3)
            bn(f"{t}.bn1", c)
            s[f"{t}.conv2.weight"] = (c, c, 3, 3)
            bn(f"{t}.bn2", c)
            if b == 0 and i > 0:
                s[f"{t}.downsample.0.weight"] = (c, cin, 1, 1)
                bn(f"{t}.downsample.1", c)
        cin = c
    s["fc.weight"], s["fc.bias"] = (1000, 512), (1000,)
    return s


def _bn(p, name, x):
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], False, 0.0,
                        1e-5)


def forward(p, x):
    x = F.relu(_bn(p, "bn1", F.conv2d(x, p["conv1.weight"], None, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for i in range(4):
        for b in range(2):
            t = f"layer{i + 1}.{b}"
            stride = 2 if (i > 0 and b == 0) else 1
            idn = x
            if f"{t}.downsample.0.weight" in p:
                idn = _bn(p, f"{t}.downsample.1",
                          F.conv2d(x, p[f"{t}.downsample.0.weight"], None,
                                   stride))
            y = F.relu(_bn(p, f"{t}.bn1", F.conv2d(x, p[f"{t}.conv1.weight"],
                                                   None, stride, 1)))
            y = _bn(p, f"{t}.bn2", F.conv2d(y, p[f"{t}.conv2.weight"], None,
                                            1, 1))
            x = F.relu(y + idn)
    return F.linear(x.mean(dim=(2, 3)), p["fc.weight"], p["fc.bias"])
