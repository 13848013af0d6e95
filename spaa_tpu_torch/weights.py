"""Bridge between ``spaa_tpu`` parameter trees and the port's
``state_dict``s, both ways.

Trees are nested dicts of numpy arrays, as the ``.flax`` checkpoint codec
(``utils.log``) or ``spaa_tpu`` itself produces them.

  - convolutions: HWIO kernel <-> OIHW ``weight``;
  - ``ConvTranspose2dTorch``: its HWIO kernel is the torch
    (in, out, kh, kw) tensor stored unflipped, so a pure transpose;
  - dense: [in, out] <-> [out, in];
  - ``EvalBatchNorm``: scale/bias/mean/var <-> weight/bias/running_mean/
    running_var.
"""

from __future__ import annotations

import numpy as np
import torch

_TCONVS = {"transConv1", "transConv2", "tconv1", "tconv2"}
_CONV_TO_TORCH = (3, 2, 0, 1)
_CONV_FROM_TORCH = (2, 3, 1, 0)
_TCONV_PERM = (2, 3, 0, 1)     # its own inverse
_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
# torchvision vgg16 'D': Sequential indices of the 13 convs and 3 linears
_VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_VGG16_FC_IDX = [0, 3, 6]


def _t(a, dtype=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(arr.astype(dtype) if dtype else arr.copy())


def _np(t: torch.Tensor, perm=None) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(perm) if perm else a)


def _sorted(tree: dict) -> dict:
    """Keys sorted at every level: the order ``spaa_tpu`` trees (and so its
    msgpack checkpoints) carry."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def _conv(name: str, p: dict, prefix: str, dtype=None) -> dict:
    perm = _TCONV_PERM if name in _TCONVS else _CONV_TO_TORCH
    out = {f"{prefix}{name}.weight": _t(np.transpose(p["kernel"], perm), dtype)}
    if "bias" in p:
        out[f"{prefix}{name}.bias"] = _t(p["bias"], dtype)
    return out


def pcnet_state_dict(params: dict, dtype=None, prefix: str = "") -> dict:
    """A ``spaa_tpu`` param tree of an image network (PCNet, CompenNet,
    CompenNet++: convolutions, transposed convolutions, WarpingNet's
    ``affine_mat`` and ``theta``) -> the port's state_dict; the module
    paths are the same names."""
    sd = {}
    for name, p in params.items():
        if name in ("affine_mat", "theta"):
            sd[f"{prefix}{name}"] = _t(p, dtype)
        elif "kernel" in p:
            sd.update(_conv(name, p, prefix, dtype))
        else:
            sd.update(pcnet_state_dict(p, dtype, f"{prefix}{name}."))
    return sd


def pcnet_params(state_dict: dict) -> dict:
    """The reverse of :func:`pcnet_state_dict`: float32 numpy leaves, keys
    sorted, which ``utils.log``'s checkpoint writer serialises for
    ``spaa_tpu.utils.log.load_checkpoint``."""
    tree: dict = {}
    for key, val in state_dict.items():
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        if leaf in ("affine_mat", "theta"):
            node[leaf] = _np(val)
        elif leaf == "weight":
            node["kernel"] = _np(val, _TCONV_PERM if mods[-1] in _TCONVS
                                 else _CONV_FROM_TORCH)
        else:
            node["bias"] = _np(val)
    return _sorted(tree)


# CompenNet and CompenNet++ are walked the same way, under flax's names
compennet_state_dict = compennet_pp_state_dict = pcnet_state_dict
compennet_params = compennet_pp_params = pcnet_params


def _bn(p: dict, prefix: str, dtype=None) -> dict:
    return {f"{prefix}.{_BN_NAMES[k]}": _t(p[k], dtype) for k in _BN_NAMES}


def resnet18_state_dict(params: dict, dtype=None) -> dict:
    """``spaa_tpu`` ResNet18 params -> torchvision-named state_dict."""
    def conv(p, key):
        return {key: _t(np.transpose(p["kernel"], _CONV_TO_TORCH), dtype)}

    sd = {}
    sd.update(conv(params["conv1"], "conv1.weight"))
    sd.update(_bn(params["bn1"], "bn1", dtype))
    for layer in range(1, 5):
        for block in range(2):
            p = params[f"layer{layer}_{block}"]
            t = f"layer{layer}.{block}"
            sd.update(conv(p["conv1"], f"{t}.conv1.weight"))
            sd.update(_bn(p["bn1"], f"{t}.bn1", dtype))
            sd.update(conv(p["conv2"], f"{t}.conv2.weight"))
            sd.update(_bn(p["bn2"], f"{t}.bn2", dtype))
            if "down_conv" in p:
                sd.update(conv(p["down_conv"], f"{t}.downsample.0.weight"))
                sd.update(_bn(p["down_bn"], f"{t}.downsample.1", dtype))
    sd["fc.weight"] = _t(np.transpose(params["fc"]["kernel"]), dtype)
    sd["fc.bias"] = _t(params["fc"]["bias"], dtype)
    return sd


def vgg16_state_dict(params: dict, dtype=None) -> dict:
    """``spaa_tpu`` VGG16 params -> torchvision-named state_dict
    (``features.<i>``, ``classifier.<i>``)."""
    sd = {}
    for i, idx in enumerate(_VGG16_CONV_IDX):
        p = params[f"conv{i}"]
        sd[f"features.{idx}.weight"] = _t(np.transpose(p["kernel"],
                                                       _CONV_TO_TORCH), dtype)
        sd[f"features.{idx}.bias"] = _t(p["bias"], dtype)
    for i, idx in enumerate(_VGG16_FC_IDX):
        p = params[f"fc{i + 1}"]
        sd[f"classifier.{idx}.weight"] = _t(np.transpose(p["kernel"]), dtype)
        sd[f"classifier.{idx}.bias"] = _t(p["bias"], dtype)
    return sd


def inception_v3_state_dict(params: dict, dtype=None) -> dict:
    """``spaa_tpu`` InceptionV3 params -> torchvision-named state_dict:
    the module paths are torchvision's already (``Mixed_5b.branch1x1``),
    every BasicConv2d is ``<name>.conv`` / ``<name>.bn``; no aux head."""
    sd = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif k == "kernel":
                perm = _CONV_TO_TORCH if v.ndim == 4 else (1, 0)
                sd[f"{prefix}weight"] = _t(np.transpose(v, perm), dtype)
            elif prefix.endswith("bn."):
                sd[f"{prefix}{_BN_NAMES[k]}"] = _t(v, dtype)
            else:
                sd[f"{prefix}{k}"] = _t(v, dtype)

    walk(params, "")
    return sd
