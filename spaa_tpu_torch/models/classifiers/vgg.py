"""VGG-16 (inference) with torchvision's module and state-dict names
(``features.<i>``, ``classifier.<i>``), so a ``vgg16-397923af.pth`` loads
as it is. Counterpart of ``spaa_tpu/models/classifiers/vgg.py``: config
'D' without BatchNorm, 13 3x3 convolutions and 5 2x2 max pools, then fully
connected 25088 -> 4096 -> 4096 -> 1000; dropout is the identity in eval
mode. NCHW inside."""

from __future__ import annotations

import torch
from torch import nn

from spaa_tpu_torch.models.classifiers.resnet import init_he_lecun

_CFG_D = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16(nn.Module):
    input_size = (224, 224)

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        layers, cin = [], 3
        for v in _CFG_D:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        # torchvision's indices: Linear, ReLU, Dropout, Linear, ReLU,
        # Dropout, Linear; the dropouts are identities in eval mode
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Identity(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Identity(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        return self.classifier(torch.flatten(x, 1))   # NCHW flatten order

    def init_weights(self, generator: torch.Generator) -> "VGG16":
        """Deterministic random init (see ``init_he_lecun``)."""
        return init_he_lecun(self, generator)
