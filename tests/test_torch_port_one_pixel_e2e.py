"""Port parity (end to end): One-pixel DE through ``run_projector_based_attack``
of both packages on one tiny sim setup (tests/test_e2e_attack.py's sizes:
camera 64x48, projector 64x64, crop 48x48; block 21 pixels, 1 generation,
population 8 untargeted and 6 targeted, ResNet-18).

- trajectory run: both packages' ``orchestrate.Classifier`` replaced by one
  float64 function of the centre crop (in each package's array type), and
  both given the same ``SimProCams``: the 11 + 11 PNGs (``prj/adv`` and
  ``cam/raw/adv``) agree within 1 count, the capture counts are equal, and
  both summarizers (the real ResNet-18) give the same One-pixel row,
  ``'-'/'-'`` included;
- ResNet-18 run (one ``.pth`` built from ``spaa_tpu``'s ``init_params``):
  the initial Latin-hypercube population, captured once, scores the same
  in both packages within 1e-5 (and the softmax of the port's ``raw``, which
  the attackers take as ``spaa_tpu``'s do, equals ``classify``'s
  probabilities within 1e-6); the port writes the reference layout, and
  ``spaa_tpu``'s summarize of the port's PNGs gives the port's row.
"""

import os
import shutil
from os.path import join

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from spaa_tpu.attack import orchestrate as JO
from spaa_tpu.attack import summarize as JS
from spaa_tpu.attack.one_pixel import BatchedDE as JaxBatchedDE
from spaa_tpu.attack.one_pixel import perturb_image_np as jax_perturb
from spaa_tpu.models.classifiers import Classifier as JaxClassifier
from spaa_tpu.models.classifiers import init_params
from spaa_tpu.utils.sim_procams import DEFAULT_SIM_SETUP_INFO, SimProCams
from spaa_tpu_torch.attack import orchestrate as TO
from spaa_tpu_torch.attack import summarize as TS
from spaa_tpu_torch.attack.one_pixel import _bounds
from spaa_tpu_torch.models.classifiers import Classifier
from spaa_tpu_torch.utils.io import imread_u8
from spaa_tpu_torch.weights import resnet18_state_dict

FOLDER = join("One-pixel_DE", "-", "-", "resnet18")
CP_SZ = (48, 48)
_A = np.random.default_rng(23).normal(0, 1, (6, 1000))


def _logits_np(im):
    """[N, 1000] float64 logits from the crop's channel means and mean
    squares."""
    im = np.asarray(im, np.float64)
    if im.ndim == 3:
        im = im[None]
    h, w = im.shape[1:3]
    i, j = round((h - CP_SZ[0]) / 2), round((w - CP_SZ[1]) / 2)
    c = im[:, i:i + CP_SZ[0], j:j + CP_SZ[1]]
    f = np.concatenate([c.mean(axis=(1, 2)), (c * c).mean(axis=(1, 2))], 1)
    return 40.0 * f @ _A


def _standin(to_raw, softmax):
    class StandIn:
        """Both packages' ``Classifier`` interface on :func:`_logits_np`."""

        def __init__(self, name, weights_dir=None, sort_results=True,
                     device=None):
            assert not sort_results
            self.name = name
            self.device = torch.device("cpu")

        def __call__(self, im, crop_sz):
            if torch.is_tensor(im):
                im = im.numpy()
            raw = to_raw(_logits_np(im))
            p = softmax(raw)
            return raw, p, np.argsort(-p, axis=1)
    return StandIn


JaxStandIn = _standin(jnp.asarray,
                      lambda r: np.asarray(jax.nn.softmax(r, axis=1)))
TorchStandIn = _standin(torch.from_numpy,
                        lambda r: torch.softmax(r, 1).numpy())


class Counting:
    """``sim.capture`` counted."""

    def __init__(self, sim):
        self.sim, self.n = sim, 0

    def capture(self, prj_im):
        self.n += 1
        return self.sim.capture(prj_im)


def _cfg(mod, root):
    cfg = mod.get_attacker_cfg("One-pixel_DE", root, ["vtest"])
    cfg.classifier_names = ["resnet18"]
    (cfg.op_pixel_size, cfg.op_maxiter, cfg.op_popsize_untargeted,
     cfg.op_popsize_targeted) = (21, 1, 8, 6)
    return cfg


def _pngs(root, sub):
    base = join(root, "setups", "vtest", sub, FOLDER)
    return {f: join(base, f) for f in sorted(os.listdir(base))}


def _rows_agree(got, want):
    """Stats rows: equal names and grid, metrics within the summarize
    tolerance of tests/test_torch_port_entry.py."""
    assert list(got.columns) == list(want.columns) and len(got) == 1 == \
        len(want)
    for col in want.columns:
        w, g = want[col].iloc[0], got[col].iloc[0]
        if col.endswith("PSNR") and np.isinf(g):
            assert w >= 120, col
        elif isinstance(w, float) and "top" not in col:
            assert abs(g - w) <= 2e-4 + 1e-5 * abs(w), col
        else:
            assert g == w, col


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one_pixel_e2e")
    info = dict(DEFAULT_SIM_SETUP_INFO)
    info.update(prj_im_sz=[64, 64], cam_im_sz=[64, 48],
                classifier_crop_sz=list(CP_SZ))
    sim = SimProCams(info)
    sim.make_setup(str(tmp / "fresh"), "vtest", num_train=4, num_test=2)
    weights = tmp / "weights"
    weights.mkdir()
    params = jax.tree.map(np.asarray, init_params("resnet18", seed=0))
    torch.save(resnet18_state_dict(params), weights / "resnet18-5c106cde.pth")
    return tmp, sim, str(weights)


def _stats(root):
    return pd.read_csv(join(root, "setups/vtest/ret/One-pixel_DE",
                            "stats.txt"), sep="\t")


def test_trajectories_and_stats_rows_equal(world, monkeypatch):
    tmp, sim, weights = world
    jroot, troot = str(tmp / "jax"), str(tmp / "port")
    shutil.copytree(tmp / "fresh", jroot)
    shutil.copytree(tmp / "fresh", troot)
    monkeypatch.setattr(JO, "Classifier", JaxStandIn)
    monkeypatch.setattr(TO, "Classifier", TorchStandIn)
    j_cap, t_cap = Counting(sim), Counting(sim)
    with enable_x64():
        JO.run_projector_based_attack(_cfg(JO, jroot), procams=j_cap)
    TO.run_projector_based_attack(_cfg(TO, troot), procams=t_cap,
                                  device="cpu")
    # per attack: npop 5, one generation (5 trials), the final capture
    assert t_cap.n == j_cap.n == 11 * (5 + 5 + 1)
    for sub in ("prj/adv", "cam/raw/adv"):
        want, got = _pngs(jroot, sub), _pngs(troot, sub)
        assert list(got) == list(want) and len(want) == 11, sub
        for f in want:
            d = np.abs(imread_u8(got[f]).astype(np.int16)
                       - imread_u8(want[f]).astype(np.int16))
            assert d.max() <= 1, (sub, f)
    JS.summarize_single_attacker("One-pixel_DE", jroot, ["vtest"],
                                 classifier_names=["resnet18"],
                                 weights_dir=weights)
    TS.summarize_single_attacker("One-pixel_DE", troot, ["vtest"],
                                 classifier_names=["resnet18"],
                                 weights_dir=weights, device="cpu")
    want, got = _stats(jroot), _stats(troot)
    assert list(got["Stealth_loss"]) == ["-"] and list(got["d_thr"]) == ["-"]
    _rows_agree(got, want)


def test_resnet18_population_layout_and_row(world):
    tmp, sim, weights = world
    prj = np.full((64, 64, 3), 0.5, np.float32)
    bounds, npop = _bounds(64, 64, 21, 1, 8)
    pop = JaxBatchedDE(None, bounds, npop, 1, seed=0)._init_population(5)
    cams = np.stack([sim.capture(jax_perturb(x, prj, 21)) for x in pop])
    _, want, _ = JaxClassifier("resnet18", weights, sort_results=False)(
        jnp.asarray(cams), CP_SZ)
    raw, got, _ = Classifier("resnet18", weights, sort_results=False,
                             device="cpu")(cams, CP_SZ)
    assert np.abs(got - want).max() <= 1e-5
    # the attackers re-softmax ``raw``, as spaa_tpu's do
    assert np.abs(torch.softmax(raw, 1).numpy() - got).max() <= 1e-6

    troot = str(tmp / "port_resnet18")
    shutil.copytree(tmp / "fresh", troot)
    TO.run_projector_based_attack(_cfg(TO, troot), procams=sim,
                                  weights_dir=weights, device="cpu")
    for sub in ("prj/adv", "cam/raw/adv"):
        assert list(_pngs(troot, sub)) == [f"img_{i:04d}.png"
                                           for i in range(1, 12)]
    TS.summarize_single_attacker("One-pixel_DE", troot, ["vtest"],
                                 classifier_names=["resnet18"],
                                 weights_dir=weights, device="cpu")
    jroot = str(tmp / "jax_resnet18")
    shutil.copytree(troot, jroot, ignore=shutil.ignore_patterns("ret"))
    JS.summarize_single_attacker("One-pixel_DE", jroot, ["vtest"],
                                 classifier_names=["resnet18"],
                                 weights_dir=weights)
    _rows_agree(_stats(troot), _stats(jroot))
