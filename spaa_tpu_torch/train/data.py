"""Per-setup data: setup info, captures, Nayar separation and the mask.

Counterpart of ``spaa_tpu/train/data.py`` (reference
``train_network.py:39-95``). Arrays are NHWC float32 numpy on the host;
training moves the train and validation images to the device once, as
uint8 (:func:`as_uint8_wire`).
"""

from __future__ import annotations

import os
import warnings
from os.path import join

import numpy as np

from spaa_tpu_torch.utils.config import DictConfig, load_flat_yaml
from spaa_tpu_torch.utils.imgproc_host import (direct_light_mask,  # noqa: F401
                                               multi_otsu, threshold_im)
from spaa_tpu_torch.utils.io import imread_dir


def load_setup_info(setup_path: str) -> DictConfig:
    """setup_info.yml with default fallback (ref ``train_network.py:85-95``)."""
    fn = join(setup_path, "setup_info.yml")
    if os.path.exists(fn):
        return load_flat_yaml(fn)
    default_fn = join(setup_path, "../setup_info_default.yml")
    warnings.warn(f"{fn} not found, loading {default_fn} instead")
    return load_flat_yaml(default_fn)


def as_uint8_wire(x) -> np.ndarray:
    """Lossless uint8 form of PNG-sourced [0, 1] float images (k/255 -> k):
    a quarter of the host-to-device copy and of the device memory; the
    training step casts the gathered minibatch back on the device."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return np.uint8(np.round(np.clip(x, 0.0, 1.0) * 255.0))


def nayar_separation(im_cb: np.ndarray, b: float = 0.9):
    """Direct/indirect light separation from shifted illumination patterns
    (Nayar TOG'06; ref ``train_network.py:69-77``).
    im_cb: [N, H, W, C]. Returns (direct, indirect) HWC images."""
    l1 = im_cb.max(axis=0)
    l2 = im_cb.min(axis=0)
    direct = (l1 - l2) / (1 - b)
    indirect = 2 * (l2 - b * l1) / (1 - b * b)
    return direct, indirect


def load_data(data_root: str, setup_name: str,
              compensation: bool = False) -> dict:
    """One setup's captures (ref ``load_data``, ``train_network.py:39-82``):
    cam_scene [1,H,W,3], cam_train/cam_valid [N,H,W,3], prj_train/prj_valid
    [N,Hp,Wp,3], mask [H,W,1] float, mask_corners (4 [x, y] in [-1, 1]),
    setup_info. ``compensation`` selects ``threshold_im``'s CompenNet++
    mask."""
    setup_path = join(data_root, "setups", setup_name)
    setup_info = load_setup_info(setup_path)
    cam_scene = imread_dir(join(setup_path, "cam/raw/ref"))[1:2]
    cam_train = imread_dir(join(setup_path, "cam/raw/train"))
    prj_train = imread_dir(join(data_root, "prj_share/train"))
    cam_valid = imread_dir(join(setup_path, "cam/raw/test"))
    prj_valid = imread_dir(join(data_root, "prj_share/test"),
                           index=list(range(cam_valid.shape[0])))
    im_direct, _ = nayar_separation(imread_dir(join(setup_path, "cam/raw/cb")),
                                    b=0.9)
    im_mask, _, mask_corners = threshold_im(im_direct,
                                            compensation=compensation)
    return dict(cam_scene=cam_scene, cam_train=cam_train, cam_valid=cam_valid,
                prj_train=prj_train, prj_valid=prj_valid,
                mask=im_mask.astype(np.float32)[..., None],
                mask_corners=mask_corners, setup_info=setup_info)
