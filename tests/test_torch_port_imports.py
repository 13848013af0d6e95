"""Port check (a): every module of ``spaa_tpu_torch`` imports without JAX,
``spaa_tpu``, a host package the GPU machine lacks, visdom or matplotlib,
an entry point called without ``device`` runs on CUDA or raises where
there is none, and what is not ported yet (the hardware ProCams, the
multi-setup paths) raises ``NotImplementedError`` naming its ROADMAP.md
item."""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import spaa_tpu_torch
from spaa_tpu_torch import main as TM
from spaa_tpu_torch import reproduce_paper_results as TR
from spaa_tpu_torch.attack.orchestrate import (get_attacker_cfg,
                                               run_projector_based_attack)
from spaa_tpu_torch.models.classifiers import Classifier
from spaa_tpu_torch.train.pipeline import (train_eval_compennet_pp,
                                           train_eval_pcnet)
from spaa_tpu_torch.train.train import get_model_train_cfg
from spaa_tpu_torch.utils.device import resolve_device
from spaa_tpu_torch.utils.imgproc_host import threshold_im

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "spaa_tpu", "cv2", "PIL",
             "yaml", "pandas", "msgpack")
PLOTTING = ("visdom", "matplotlib")

_PROBE = """
import importlib, json, pkgutil, sys
import spaa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(spaa_tpu_torch.__path__,
                                               "spaa_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "loaded": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_port_imports_nothing_forbidden():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = [m.name for m in pkgutil.walk_packages(
        spaa_tpu_torch.__path__, "spaa_tpu_torch.")]
    assert sorted(res["modules"]) == sorted(expected)
    for name in ("ops.warp", "utils.table", "utils.xlsx", "utils.procams",
                 "attack.summarize", "main", "reproduce_paper_results",
                 "attack.perc_al", "models.compen_net", "models.init",
                 "attack.one_pixel", "digital_one_pixel_attack",
                 "utils.vis"):
        assert "spaa_tpu_torch." + name in res["modules"], name
    assert not set(res["loaded"]) & set(FORBIDDEN), res["loaded"]
    assert not set(res["loaded"]) & set(PLOTTING), res["loaded"]


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    for name in ("resnet18", "vgg16", "inception_v3"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Classifier(name)
    cfg = get_attacker_cfg("SPAA", str(tmp_path), ["none"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_projector_based_attack(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_eval_pcnet(get_model_train_cfg(["PCNet"], str(tmp_path),
                                             ["none"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_eval_compennet_pp(get_model_train_cfg(
            ["CompenNet++"], str(tmp_path), ["none"]))
    for name in ("PerC-AL+CompenNet++", "One-pixel_DE"):
        cfg = get_attacker_cfg(name, str(tmp_path), ["none"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_projector_based_attack(cfg)
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_unported_parts_raise_not_implemented(tmp_path):
    root = str(tmp_path)
    with pytest.raises(NotImplementedError, match="HardwareProCams"):
        TM.main(["--data-root", root, "--device", "cpu", "--hardware"])
    for flag in ("--multi-setup-train", "--multi-setup-attack"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue A item 7"):
            TR.main(["--data-root", root, "--device", "cpu", "--sim", flag])
    assert not os.listdir(tmp_path), "nothing may run before the raise"
    # PerC-AL+CompenNet++ and One-pixel DE are ported: they get as far as
    # reading the setup
    for name in ("PerC-AL+CompenNet++", "One-pixel_DE"):
        cfg = get_attacker_cfg(name, root, ["none"])
        with pytest.raises(FileNotFoundError):
            run_projector_based_attack(cfg, device="cpu")
    # ... and so is CompenNet++'s mask
    mask = np.zeros((6, 8), bool)
    mask[1:4, 2:7] = True
    _, roi, corners = threshold_im(mask, compensation=True)
    assert roi.sum() == 15 and corners[0] == [2 * 2 / 8 - 1, 2 * 1 / 6 - 1]
