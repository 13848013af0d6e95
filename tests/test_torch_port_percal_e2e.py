"""Port parity (end to end): PerC-AL+CompenNet++ through
``run_projector_based_attack`` of both packages on one tiny sim setup
(tests/test_e2e_attack.py's sizes: camera 64x48, projector 64x64, 16
training pairs; CompenNet pre-trained 2 iterations, CompenNet++ 3, PerC-AL
3, ResNet-18 from one ``.pth`` built from ``spaa_tpu``'s ``init_params``).
``spaa_tpu`` trains and attacks first.

- with ``load_pretrained`` the port finds both of ``spaa_tpu``'s
  checkpoints (the CompenNet pre-training's and CompenNet++'s, under the
  ``max_iters`` override and the ``num_train`` clamp), and its sweep and
  validation write the same 26 PNGs within 1 count (float32 on two
  libraries: a value near a ``.5`` of the 8-bit quantisation rounds
  either way; measured: 165, 203 and 2 pixels of the camera-space,
  projector and validation images differ, each by 1);
- without it the port pre-trains CompenNet and trains CompenNet++ itself,
  drawing the same minibatch plans as ``spaa_tpu`` (the pre-training's
  continues the Python RNG state the caller left, then
  ``reset_rng_seeds(0)``); ``spaa_tpu`` reads both of its checkpoints, and
  its weights agree with ``spaa_tpu``'s to the float32 Adam drift the test
  states (measured 2.2e-4 and 2.7e-3; the loops are held to 1e-9 in
  float64 in test_torch_port_compennet.py).
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
from spaa_tpu.train import pipeline as JP
from spaa_tpu.utils import log as JL
from spaa_tpu.utils.sim_procams import DEFAULT_SIM_SETUP_INFO, SimProCams
from spaa_tpu_torch.attack import orchestrate as TO
from spaa_tpu_torch.train import pipeline as TP
from spaa_tpu_torch.utils.io import imread_u8
from spaa_tpu_torch.weights import resnet18_state_dict

CKPT = "vtest_CompenNet++_l1+ssim_16_16_3_0.001_0.2_800_0.0001.flax"
INIT_CKPT = TP.INIT_CKPT_NAME + ".flax"


def _pngs(root, sub):
    base = join(root, "setups", "vtest", sub)
    return {os.path.relpath(join(d, f), base): join(d, f)
            for d, _, files in os.walk(base) for f in files}


def _diffs(want_root, got_root, sub):
    want, got = _pngs(want_root, sub), _pngs(got_root, sub)
    assert sorted(got) == sorted(want) and want, sub
    return {k: np.abs(imread_u8(p).astype(np.int16)
                      - imread_u8(got[k]).astype(np.int16))
            for k, p in want.items()}


def _cfg_for(mod, root):
    cfg = mod.get_attacker_cfg("PerC-AL+CompenNet++", root, ["vtest"])
    cfg.max_iters = 3            # CompenNet++ training
    cfg.init_max_iters = 2       # CompenNet pre-training
    cfg.attack_iters = 3
    cfg.classifier_names = ["resnet18"]
    return cfg


def _recording(mod, plans):
    """``mod.sample_batch_indices`` wrapped to record every plan drawn."""
    orig = mod.sample_batch_indices

    def wrapped(*args, **kw):
        plans.append(orig(*args, **kw))
        return plans[-1]
    return orig, wrapped


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """spaa_tpu's train-then-attack on the tiny setup, the minibatch plans
    it drew, and a copy of the setup from before the run."""
    tmp = tmp_path_factory.mktemp("percal_e2e")
    data = str(tmp / "jax" / "data")
    info = dict(DEFAULT_SIM_SETUP_INFO)
    info.update(prj_im_sz=[64, 64], cam_im_sz=[64, 48],
                classifier_crop_sz=[48, 48])
    SimProCams(info).make_setup(data, "vtest", num_train=16, num_test=4)
    shutil.copytree(tmp / "jax", tmp / "fresh")
    weights = tmp / "weights"
    weights.mkdir()
    params = jax.tree.map(np.asarray, init_params("resnet18", seed=0))
    torch.save(resnet18_state_dict(params), weights / "resnet18-5c106cde.pth")
    plans = []
    orig, JP.sample_batch_indices = _recording(JP, plans)
    try:
        JO.run_projector_based_attack(_cfg_for(JO, data),
                                      weights_dir=str(weights))
    finally:
        JP.sample_batch_indices = orig
    return tmp, data, str(weights), plans


def test_port_loads_spaa_tpu_checkpoints_and_attacks_alike(jax_run):
    tmp, data, weights, _ = jax_run
    proot = tmp / "port_loads"
    shutil.copytree(tmp / "jax", proot)
    for sub in ("prj/adv", "cam/infer/adv", "prj/infer/test"):
        shutil.rmtree(proot / "data" / "setups" / "vtest" / sub)
    cfg = _cfg_for(TO, str(proot / "data"))
    cfg.load_pretrained = True
    TO.run_projector_based_attack(cfg, weights_dir=weights, device="cpu")
    cam = _diffs(data, str(proot / "data"), "cam/infer/adv")
    prj = _diffs(data, str(proot / "data"), "prj/adv")
    valid = _diffs(data, str(proot / "data"), "prj/infer/test")
    assert len(cam) == len(prj) == 11 and len(valid) == 4
    for key, d in {**cam, **prj, **valid}.items():
        assert d.max() <= 1, key


def test_port_trains_compennet_pp_like_spaa_tpu(jax_run, monkeypatch):
    tmp, data, weights, jax_plans = jax_run
    proot = tmp / "port_trains"
    shutil.copytree(tmp / "fresh", proot)
    plans = []
    orig, wrapped = _recording(TP, plans)
    monkeypatch.setattr(TP, "sample_batch_indices", wrapped)
    TO.run_projector_based_attack(_cfg_for(TO, str(proot / "data")),
                                  weights_dir=weights, device="cpu")
    # the pre-training's plan (16 pairs, batch 16, 2 iterations), then
    # CompenNet++'s, each as spaa_tpu drew it
    assert [p.shape for p in plans] == [p.shape for p in jax_plans] \
        == [(2, 16), (3, 16)]
    for got, want in zip(plans, jax_plans):
        np.testing.assert_array_equal(got, want)

    for name in (INIT_CKPT, CKPT):
        ckpt_t = join(proot, "checkpoint", name)
        ckpt_j = join(tmp, "jax", "checkpoint", name)
        want = JL.load_checkpoint(ckpt_j, jax.tree.map(
            np.zeros_like, TP.L.load_checkpoint(ckpt_j)))
        got = JL.load_checkpoint(ckpt_t, want)   # spaa_tpu reads the port's
        # float32 Adam: an element whose gradient is at rounding level
        # steps +-lr (1e-3) either way, so after 2 + 3 updates the weights
        # agree to a few such steps
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                       atol=1e-2, err_msg=f"{name} {path}")
    assert len(_pngs(str(proot / "data"), "prj/adv")) == 11
