"""Port parity (end to end): ``run_projector_based_attack`` of both
packages on one tiny sim setup (tests/test_e2e_attack.py's sizes, 3 attack
iterations, one caml2 and one camdE config, classifiers from the same
``.pth`` files built from ``spaa_tpu``'s ``init_params``). ``spaa_tpu``
trains PCNet for 3 iterations and saves it.

- with ``load_pretrained`` the port finds that checkpoint under the same
  key (the ``max_iters`` override and the ``num_train`` clamp) and the
  saved PNGs agree within 1 uint8 count (both float32 on the CPU, with
  convolutions summed in different orders);
- without it the port trains PCNet itself through ``train_eval_pcnet``,
  from the initial parameters it draws as ``spaa_tpu`` does, and attacks
  VGG-16; its checkpoint loads in ``spaa_tpu``. Three float32 Adam steps on two
  libraries do not stay within 1 count: Adam's first steps are about
  lr * sign(g), and a gradient element at rounding level takes either
  sign (verify SKILL section 3). The tolerances stated in the test bound
  that drift; ``test_torch_port_train.py`` holds the same loop to 1e-9 in
  float64.
"""

import os
import shutil
from os.path import join

import numpy as np
import pytest
import torch

import jax

from spaa_tpu.attack import orchestrate as JO
from spaa_tpu.models.classifiers import init_params
from spaa_tpu.utils import log as JL
from spaa_tpu.utils.sim_procams import DEFAULT_SIM_SETUP_INFO, SimProCams
from spaa_tpu_torch.attack import orchestrate as TO
from spaa_tpu_torch.train import pipeline as TP
from spaa_tpu_torch.utils.io import imread_u8
from spaa_tpu_torch.weights import (pcnet_params, pcnet_state_dict,
                                    resnet18_state_dict, vgg16_state_dict)

CKPT = "vtest_PCNet_l1+ssim_16_16_3_0.001_0.2_800_0.0001.flax"


def _pngs(root, subs=("prj/adv", "cam/infer/adv")):
    out = {}
    for sub in subs:
        base = join(root, "setups", "vtest", sub)
        for dirpath, _, files in os.walk(base):
            for f in files:
                out[os.path.relpath(join(dirpath, f), base) + "@" + sub] = \
                    join(dirpath, f)
    return out


def _png_diffs(want, got):
    """{key: |a - b|} over the decoded uint8 PNGs of both runs."""
    assert sorted(got) == sorted(want)
    return {key: np.abs(imread_u8(path).astype(np.int16)
                        - imread_u8(got[key]).astype(np.int16))
            for key, path in want.items()}


def _assert_pngs_close(want, got):
    for key, d in _png_diffs(want, got).items():
        assert d.max() <= 1, key


def _cfg_for(mod, root, classifier):
    cfg = mod.get_attacker_cfg("SPAA", root, ["vtest"])
    cfg.max_iters = 3            # tiny PCNet training
    cfg.attack_iters = 3
    cfg.classifier_names = [classifier]
    cfg.stealth_losses = ["caml2", "camdE"]
    cfg.d_threshes = [5]
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """spaa_tpu's train-then-attack on the tiny setup, ResNet-18 and
    VGG-16, and a copy of the setup from before the run."""
    tmp = tmp_path_factory.mktemp("e2e")
    data = str(tmp / "jax" / "data")
    info = dict(DEFAULT_SIM_SETUP_INFO)
    info.update(prj_im_sz=[64, 64], cam_im_sz=[64, 48],
                classifier_crop_sz=[48, 48])
    SimProCams(info).make_setup(data, "vtest", num_train=16, num_test=4)
    shutil.copytree(tmp / "jax", tmp / "fresh")
    weights = tmp / "weights"
    weights.mkdir()
    for name, bridge, fname in (
            ("resnet18", resnet18_state_dict, "resnet18-5c106cde.pth"),
            ("vgg16", vgg16_state_dict, "vgg16-397923af.pth")):
        params = jax.tree.map(np.asarray, init_params(name, seed=0))
        torch.save(bridge(params), weights / fname)
    cfg = _cfg_for(JO, data, "resnet18")
    cfg.classifier_names = ["resnet18", "vgg16"]
    JO.run_projector_based_attack(cfg, weights_dir=str(weights))
    return tmp, data, str(weights)


def test_run_projector_based_attack_matches_spaa_tpu(jax_run):
    tmp, data, weights = jax_run
    # the port starts from the setup and the checkpoint spaa_tpu saved
    proot = tmp / "port_loads"
    shutil.copytree(tmp / "jax", proot)
    for sub in ("prj/adv", "cam/infer/adv"):
        shutil.rmtree(proot / "data" / "setups" / "vtest" / sub)
    cfg = _cfg_for(TO, str(proot / "data"), "resnet18")
    cfg.load_pretrained = True
    TO.run_projector_based_attack(cfg, weights_dir=weights, device="cpu")
    want = {k: v for k, v in _pngs(data).items() if "/resnet18/" in k}
    got = _pngs(str(proot / "data"))
    assert len(want) == 44
    _assert_pngs_close(want, got)


def test_port_trains_pcnet_then_attacks_like_spaa_tpu(jax_run):
    tmp, data, weights = jax_run
    proot = tmp / "port_trains"
    shutil.copytree(tmp / "fresh", proot)
    TO.run_projector_based_attack(_cfg_for(TO, str(proot / "data"), "vgg16"),
                                  weights_dir=weights, device="cpu")

    ckpt_t = join(proot, "checkpoint", CKPT)
    ckpt_j = join(tmp, "jax", "checkpoint", CKPT)
    want = JL.load_checkpoint(ckpt_j, jax.tree.map(
        np.zeros_like, TP.L.load_checkpoint(ckpt_j)))
    got = JL.load_checkpoint(ckpt_t, want)      # spaa_tpu reads the port's
    assert sorted(pcnet_params(
        pcnet_state_dict(TP.L.load_checkpoint(ckpt_t)))) == sorted(want)
    # float32 Adam: an element whose gradient is at rounding level steps
    # +-lr in either package (lr 1e-2 for the affine and TPS group), so
    # the weights agree to one such step; measured 3.0e-3 at most
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=1e-2, err_msg=str(path))
    # ... and the images through those weights, as stated tolerances:
    # each PNG's mean |diff| <= 1 count and its max <= 64 counts; at least
    # half of the attack's PNGs within 1 count (measured: means at most
    # 0.14 and 0.31, maxima 15 and 43, 40 of 44 attack PNGs within 1)
    valid = ("cam/infer/test",)
    d_valid = _png_diffs(_pngs(data, valid), _pngs(str(proot / "data"), valid))
    want_adv = {k: v for k, v in _pngs(data).items() if "/vgg16/" in k}
    d_adv = _png_diffs(want_adv, _pngs(str(proot / "data")))
    assert len(d_valid) == 4 and len(d_adv) == 44
    for key, d in {**d_valid, **d_adv}.items():
        assert d.mean() <= 1.0 and d.max() <= 64, key
    assert sum(d.max() <= 1 for d in d_adv.values()) >= len(d_adv) / 2
