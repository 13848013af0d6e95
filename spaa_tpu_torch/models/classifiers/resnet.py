"""ResNet-18 (inference) with torchvision's module and state-dict names,
so a ``resnet18-5c106cde.pth`` loads as it is. Counterpart of
``spaa_tpu/models/classifiers/resnet.py``; NCHW inside."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class EvalBatchNorm(nn.Module):
    """Inference BatchNorm with torchvision's names:
    y = x * inv + (bias - mean * inv), inv = weight / sqrt(var + eps),
    the same arithmetic as ``spaa_tpu``'s ``EvalBatchNorm``."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = EvalBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = EvalBatchNorm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                EvalBatchNorm(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class ResNet18(nn.Module):
    """7x7/2 stem, 3x3/2 max pool (pad 1), 4 stages x 2 BasicBlocks
    (64/128/256/512), global average pool, 1000-way fc."""
    input_size = (224, 224)

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = EvalBatchNorm(64)
        inplanes = 64
        for i, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            for b in range(2):
                stride = 2 if (i > 0 and b == 0) else 1
                down = b == 0 and (stride != 1 or inplanes != planes)
                blocks.append(BasicBlock(inplanes, planes, stride, down))
                inplanes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(x.mean(dim=(2, 3)))

    def init_weights(self, generator: torch.Generator) -> "ResNet18":
        """Deterministic random init (see ``init_he_lecun``)."""
        return init_he_lecun(self, generator)


def init_he_lecun(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Deterministic random init of a classifier from ``generator``,
    used when no pretrained weights are found: He-normal convolutions,
    LeCun-normal linears, zero biases, identity BatchNorm."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * (gain / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return net
