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
CLASSIFY_CHUNK = 64     # images a classification pass

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


def _mean_std(x: torch.Tensor):
    return (torch.as_tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device),
            torch.as_tensor(IMAGENET_STD, dtype=x.dtype, device=x.device))


def normalize_imagenet(im: torch.Tensor) -> torch.Tensor:
    """ImageNet standardisation, NHWC."""
    mean, std = _mean_std(im)
    return (im - mean) / std


def unnormalize_imagenet(im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_imagenet` (ref ``UnNormalize``,
    ``classifier.py:79-94``)."""
    mean, std = _mean_std(im)
    return im * std + mean


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
        mean, std = _mean_std(x)
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
        """Large stacks (summarize classifies whole sweeps) run
        ``CLASSIFY_CHUNK`` images at a time, to bound the activations' peak
        memory; uint8 stacks are cast to float chunk by chunk."""
        chunk = CLASSIFY_CHUNK
        im = torch.as_tensor(im, device=self.device)
        if im.ndim == 3:
            im = im[None]
        with torch.no_grad():
            raw = torch.cat([self.logits(_float01(im[s:s + chunk]), crop_sz)
                             for s in range(0, im.shape[0], chunk)])
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


def _float01(im: torch.Tensor) -> torch.Tensor:
    return im.float() / 255.0 if im.dtype == torch.uint8 else im


def params_source(model_name: str, weights_dir: Optional[str] = None) -> str:
    """Where :func:`build_classifier` gets this model's weights: 'pth' (the
    pinned torchvision file) or 'random'."""
    if model_name not in _MODELS:
        raise ValueError(f"{model_name} not supported")
    pth = join(weights_dir or DEFAULT_WEIGHTS_DIR,
               PRETRAINED_FILES[model_name])
    return "pth" if os.path.exists(pth) else "random"


def query_multi_classifiers(im, cp_sz, classifier_names, imagenet_labels,
                            weights_dir=None, device=None):
    """Ref ``classifier.py:97-106``: each classifier's top-1 label and
    confidence on ``im`` (the agreement check across the zoo)."""
    labels, confidence = [], []
    for name in classifier_names:
        clf = Classifier(name, weights_dir, sort_results=False,
                         device=device)
        _, p, _ = clf(im, cp_sz)
        labels.append(imagenet_labels[int(p.argmax())])
        confidence.append(float(p.max()))
        print(f"{name:<15}: {labels[-1]:<20} ({confidence[-1]:.2f})")
    return labels, confidence


def idx_to_label(imgnet_labels: dict, idx) -> list:
    """ImageNet labels for a list/array of positional indices
    (ref ``utils.py:744-746``)."""
    values = list(imgnet_labels.values())
    return [values[int(x)] for x in idx]


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
