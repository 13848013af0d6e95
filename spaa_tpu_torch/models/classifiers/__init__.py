"""Classifier zoo and the classify pipeline (counterpart of
``spaa_tpu/models/classifiers/__init__.py``, reference ``classifier.py``).

ResNet-18, VGG-16 and Inception-v3 (224x224, 224x224 and 299x299 inputs).
Weights come from the pinned torchvision ``.pth`` in the weights directory
when one is there (loaded as it is: the module names are torchvision's;
Inception's auxiliary head is dropped), else from a deterministic init
seeded by a ``torch.Generator``.
"""

from __future__ import annotations

import ast
import json
import os
from os.path import join
from typing import Callable, Optional

import numpy as np
import torch

from spaa_tpu_torch.models.classifiers.inception import InceptionV3
from spaa_tpu_torch.models.classifiers.resnet import ResNet18
from spaa_tpu_torch.models.classifiers.vgg import VGG16
from spaa_tpu_torch.ops.image import center_crop_nchw, resize_area_nchw
from spaa_tpu_torch.utils.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

PRETRAINED_FILES = {"resnet18": "resnet18-5c106cde.pth",
                    "vgg16": "vgg16-397923af.pth",
                    "inception_v3": "inception_v3_google-0cc3c7bd.pth"}
_MODELS = {"resnet18": ResNet18, "vgg16": VGG16, "inception_v3": InceptionV3}

_REPO = os.path.abspath(join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "..", ".."))
DEFAULT_WEIGHTS_DIR = join(_REPO, "checkpoint")


def build_classifier(model_name: str, weights_dir: Optional[str] = None,
                     seed: int = 0, device=None):
    """Frozen eval-mode network on ``device`` (default ``cuda``) and the
    source of its weights ('pth' or 'random')."""
    if model_name not in _MODELS:
        raise ValueError(f"{model_name} not supported")
    device = resolve_device(device)
    net = _MODELS[model_name]()
    if weights_dir is None:
        weights_dir = DEFAULT_WEIGHTS_DIR
    pth = join(weights_dir, PRETRAINED_FILES[model_name])
    if os.path.exists(pth):
        sd = torch.load(pth, map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items()
              if not (k.endswith("num_batches_tracked")
                      or k.startswith("AuxLogits."))}
        net.load_state_dict(sd)
        source = "pth"
    else:
        net.init_weights(torch.Generator().manual_seed(seed))
        source = "random"
    net = net.to(device).eval()
    for p in net.parameters():
        p.requires_grad_(False)
    return net, source


def make_logits_fn(net: torch.nn.Module, crop_sz=(240, 240)) -> Callable:
    """``logits_fn(im)``: the differentiable classify pipeline on NHWC
    [0, 1] images (ref ``classifier.py:55-60``): centre crop, 'area'
    resize to the net's input, ImageNet normalise, forward -> raw logits."""
    input_sz = net.input_size

    def logits_fn(im: torch.Tensor) -> torch.Tensor:
        if im.ndim == 3:
            im = im[None]
        x = center_crop_nchw(im.permute(0, 3, 1, 2), crop_sz)
        x = resize_area_nchw(x, input_sz)
        mean = torch.as_tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean[:, None, None]) / std[:, None, None]
        return net(x)

    return logits_fn


class Classifier:
    """Host-facing wrapper with the reference's return convention
    (``classifier.py:55-75``): ``classify(im, crop_sz)`` ->
    (raw logits tensor, p_sorted ndarray, idx ndarray)."""

    def __init__(self, model_name: str, weights_dir: Optional[str] = None,
                 sort_results: bool = True, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.name = model_name
        self.sort_results = sort_results
        self.net, self.params_source = build_classifier(
            model_name, weights_dir, seed, self.device)
        self.input_sz = self.net.input_size
        self.loaded_pretrained = self.params_source != "random"

    def logits(self, im: torch.Tensor, crop_sz=(240, 240)) -> torch.Tensor:
        return make_logits_fn(self.net, crop_sz)(im)

    def classify(self, im, crop_sz=(240, 240)):
        im = torch.as_tensor(im, device=self.device)
        if im.dtype == torch.uint8:
            im = im.float() / 255.0
        with torch.no_grad():
            raw = self.logits(im, crop_sz)
        p = torch.softmax(raw, dim=1).cpu().numpy()
        if self.sort_results:
            idx = np.argsort(-p, axis=1, kind="stable")
            p_sorted = np.take_along_axis(p, idx, axis=1)
        else:
            p_sorted = p
            idx = np.tile(np.arange(p.shape[1]), (p.shape[0], 1))
        return raw, p_sorted, idx

    def __call__(self, im, crop_sz=(240, 240)):
        return self.classify(im, crop_sz)


def load_imagenet_labels(filename: str) -> dict:
    """{idx: short label} (ref ``classifier.py:109-116``), from the
    dataset's ``.txt`` dict literal or a ``.json`` mapping; falls back to
    the repository's ``data/<basename>.json`` when ``filename`` is absent."""
    if not os.path.exists(filename):
        base = os.path.splitext(os.path.basename(filename))[0]
        packaged = join(_REPO, "data", base + ".json")
        if os.path.exists(packaged):
            filename = packaged
    with open(filename) as f:
        text = f.read()
    if filename.endswith(".json"):
        labels = {int(k): v for k, v in json.loads(text).items()}
    else:
        labels = ast.literal_eval(text)
    return {k: v.split(",")[0] for k, v in labels.items()}
