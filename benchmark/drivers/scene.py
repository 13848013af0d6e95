"""A configuration's fixed inputs, read by the benchmark from the raw files
it names: the camera scene, the direct-light mask, PCNet's trained
checkpoint (as PyTorch-named arrays), and the sizes."""

from __future__ import annotations

from os.path import join

import numpy as np
import torch

from benchmark.harness import ROOT
from benchmark.reference import inputs as I


class Scene:
    def __init__(self, config: dict):
        self.config = config
        # the sizes are (width, height), as setup_info.yml gives them
        self.cam_hw = tuple(int(v) for v in config["cam_im_sz"][::-1])
        self.prj_hw = tuple(int(v) for v in config["prj_im_sz"][::-1])
        self.crop_hw = tuple(int(v)
                             for v in config["classifier_crop_sz"][::-1])
        d = join(ROOT, config["setup_dir"])
        scene = I.read_png(join(d, config["scene_image"]))
        self.scene = I.center_crop(scene, self.cam_hw).astype(np.float32) / 255
        cb = np.stack([I.read_png(join(d, f)) for f in config["cb_images"]])
        mask = I.direct_light_mask(cb.astype(np.float32) / 255)
        self.mask = I.center_crop(mask, self.cam_hw).astype(np.float32)
        self.corners = I.mask_corners(self.mask > 0)

    def pcnet_params(self, device, dtype=torch.float32) -> dict:
        """The trained checkpoint named by the configuration."""
        tree = I.read_flax_checkpoint(join(ROOT,
                                           self.config["pcnet_checkpoint"]))
        return {k: torch.from_numpy(np.array(v)).to(device, dtype)
                for k, v in I.flax_to_torch_names(tree).items()}

    def tensors(self, device, dtype=torch.float32):
        """(scene [1, H, W, 3], mask [H, W]) on ``device``."""
        return (torch.from_numpy(self.scene[None]).to(device, dtype),
                torch.from_numpy(self.mask).to(device, dtype))


def import_attr(path: str):
    """``"package.module:Name"`` -> the object."""
    import importlib
    mod, _, name = path.partition(":")
    return getattr(importlib.import_module(mod), name)
