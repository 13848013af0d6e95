"""Port entry points: ``spaa_tpu_torch.main`` and
``spaa_tpu_torch.reproduce_paper_results`` on the CPU at tiny sizes.

- ``main --steps 1-7,10`` (sim 32x32 projector, 32x24 camera, 8 training
  pairs, 3 PCNet iterations, 2 attack iterations, ResNet-18, one loss and
  one threshold) writes the reference layout and a 71-column table, and
  ``spaa_tpu``'s ``summarize_single_attacker`` on the port's own PNGs
  gives the same table (both read one ``.pth`` made from ``spaa_tpu``'s
  seeded parameters);
- ``reproduce_paper_results --sim --summarize-only`` on a synthetic
  ``sim_benchmark`` tree writes ``stats_all``, the pivot and the phase
  JSON;
- ``main --steps 1,2,8,10`` (PerC-AL+CompenNet++ at the same sizes) writes
  its layout, a 71-column row and ``stats_all``; then
  ``reproduce_paper_results --summarize-only`` runs the default attacker
  list (SPAA and PerC-AL);
- what is not ported (One-pixel DE, the ``--multi-setup-*`` flags, the
  hardware) raises ``NotImplementedError`` before any work, and both
  entry points default to ``cuda``.
"""

import glob
import json
import os
import shutil
from os.path import join

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from spaa_tpu.attack import summarize as JS
from spaa_tpu.models.classifiers import init_params
from spaa_tpu_torch import main as TM
from spaa_tpu_torch import reproduce_paper_results as TR
from spaa_tpu_torch.attack.orchestrate import to_attacker_cfg_str
from spaa_tpu_torch.utils.xlsx import read_xlsx
from spaa_tpu_torch.weights import resnet18_state_dict
from test_summarize import _write_setup

CFG = to_attacker_cfg_str("SPAA")[0]


def _weights(tmp_path):
    w = tmp_path / "weights"
    w.mkdir()
    params = jax.tree.map(np.asarray, init_params("resnet18", seed=0))
    torch.save(resnet18_state_dict(params), w / "resnet18-5c106cde.pth")
    return str(w)


def test_main_steps_1_to_7_and_10_on_cpu(tmp_path):
    weights = _weights(tmp_path)
    data = str(tmp_path / "data")
    TM.main(["--data-root", data, "--setup-name", "vtest", "--steps",
             "1-7,10", "--device", "cpu", "--sim-size", "32", "32", "32",
             "24", "--num-train", "8", "--train-iters", "3",
             "--attack-iters", "2", "--classifiers", "resnet18",
             "--stealth-losses", "caml2", "--d-threshes", "5",
             "--weights-dir", weights])
    setup = join(data, "setups", "vtest")
    folder = join(CFG, "caml2", "5", "resnet18")
    for sub in ("prj/adv", "cam/infer/adv", "cam/raw/adv", "ret"):
        assert len(glob.glob(join(setup, sub, folder, "img_*.png"))) == 11
    assert len(os.listdir(join(data, "setups/sync_test/cam/raw/numbers"))) \
        == 10
    for f in ("stats.txt", "stats.xlsx"):
        assert os.path.exists(join(setup, "ret", CFG, f))
    for f in ("stats_all.txt", "stats_all.xlsx", "pivot_table_all.xlsx"):
        assert os.path.exists(join(data, "setups", f))
    assert glob.glob(join(data, "..", "log", "*.xlsx"))
    got = pd.read_csv(join(setup, "ret", CFG, "stats.txt"), sep="\t")
    assert got.shape == (1, 71)
    assert pd.read_csv(join(data, "setups/stats_all.txt"),
                       sep="\t").shape == (1, 71)
    assert len(read_xlsx(join(data, "setups/pivot_table_all.xlsx"))) == 2

    # spaa_tpu summarizes the port's PNGs: the same table
    jroot = str(tmp_path / "jax")
    shutil.copytree(data, jroot)
    shutil.rmtree(join(jroot, "setups/vtest/ret"))
    JS.summarize_single_attacker("SPAA", jroot, ["vtest"],
                                 weights_dir=weights,
                                 classifier_names=["resnet18"],
                                 stealth_losses=["caml2"], d_threshes=[5])
    want = pd.read_csv(join(jroot, "setups/vtest/ret", CFG, "stats.txt"),
                       sep="\t")
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        w, g = want[col].iloc[0], got[col].iloc[0]
        if col.endswith("PSNR") and np.isinf(g):
            # identical images (an unsuccessful attack keeps the scene):
            # the port's mse is 0; spaa_tpu's jitted x / 255 multiplies by
            # the reciprocal, 1 ulp off for 126 of 256 values: ~150 dB
            assert w >= 120, col
        elif isinstance(w, float) and "top" not in col:
            assert abs(g - w) <= 2e-4 + 1e-5 * abs(w), col
        else:
            assert g == w, col


def test_reproduce_summarize_only_on_cpu(tmp_path):
    bench = str(tmp_path / "sim_benchmark")
    _write_setup(bench, "sim_setup", [("caml2", 5, "inception_v3", None)],
                 np.random.default_rng(5))
    phase_json = str(tmp_path / "phases.json")
    TR.main(["--sim", "--data-root", str(tmp_path), "--attackers", "SPAA",
             "--summarize-only", "--device", "cpu", "--phase-json",
             phase_json])
    stats = pd.read_csv(join(bench, "setups/stats_all.txt"), sep="\t")
    assert stats.shape == (1, 71)
    assert list(stats["Classifier"]) == ["inception_v3"]
    pivot = read_xlsx(join(bench, "setups/pivot_table_all.xlsx"))
    assert pivot[0][:4] == ["Attacker", "d_thr", "Stealth_loss",
                            "Classifier"] and len(pivot) == 2
    rec = json.load(open(phase_json))
    assert rec["stats_all_rows"] == 1 and rec["attackers"] == ["SPAA"]
    assert [p["phase"] for p in rec["phases"]] == ["summarize_all"]
    assert len(glob.glob(join(bench, "setups/sim_setup/ret/**/img_*.png"),
                         recursive=True)) == 11


def test_main_step_8_and_the_default_attackers_on_cpu(tmp_path):
    """``main --steps 1,2,8,10`` (PerC-AL+CompenNet++: CompenNet pre-trained
    and CompenNet++ trained 3 iterations, PerC-AL 2 iterations, ResNet-18,
    its one (camdE, 11) config), then ``reproduce_paper_results
    --summarize-only`` with the default attacker list (SPAA and PerC-AL
    without ``--sim``)."""
    weights = _weights(tmp_path)
    data = str(tmp_path / "data")
    TM.main(["--data-root", data, "--setup-name", "vtest", "--steps",
             "1,2,8,10", "--device", "cpu", "--sim-size", "32", "32", "32",
             "24", "--num-train", "8", "--train-iters", "3",
             "--attack-iters", "2", "--classifiers", "resnet18",
             "--weights-dir", weights])
    setup = join(data, "setups", "vtest")
    pcfg = to_attacker_cfg_str("PerC-AL+CompenNet++")[0]
    folder = join(pcfg, "camdE", "11", "resnet18")
    for sub in ("prj/adv", "cam/infer/adv", "cam/raw/adv", "ret"):
        assert len(glob.glob(join(setup, sub, folder, "img_*.png"))) == 11
    assert os.path.exists(join(data, "..", "checkpoint",
                               "init_CompenNet_l1+ssim_500_48_500_0.001_0.2_"
                               "800_0.0001.flax"))
    assert len(os.listdir(join(setup, "prj/infer/test",
                               "CompenNet++_l1+ssim_8_8_3"))) == 3
    got = pd.read_csv(join(setup, "ret", pcfg, "stats.txt"), sep="\t")
    assert got.shape == (1, 71)
    assert list(got["Stealth_loss"]) == ["camdE"] and list(got["d_thr"]) \
        == [11]
    stats = pd.read_csv(join(data, "setups/stats_all.txt"), sep="\t")
    assert list(stats["Attacker"]) == [pcfg]     # step 10: no SPAA table

    # summarize's full grid stops a row at its first missing classifier
    # (inception_v3 < resnet18): the ResNet-18 images stand in for it
    for sub in ("prj/adv", "cam/infer/adv", "cam/raw/adv"):
        shutil.copytree(join(setup, sub, folder), join(
            setup, sub, pcfg, "camdE", "11", "inception_v3"))
    phase_json = str(tmp_path / "phases.json")
    TR.main(["--data-root", data, "--setups", "vtest", "--summarize-only",
             "--device", "cpu", "--weights-dir", weights, "--phase-json",
             phase_json])
    rec = json.load(open(phase_json))
    assert rec["attackers"] == ["SPAA", "PerC-AL+CompenNet++"]
    assert rec["stats_all_rows"] == 2
    pivot = read_xlsx(join(data, "setups/pivot_table_all.xlsx"))
    assert len(pivot) == 3 and {r[0] for r in pivot[1:]} == {pcfg}


def test_unported_paths_raise_and_cuda_is_the_default(tmp_path):
    root = str(tmp_path)
    for argv, what in ((["--hardware"], "HardwareProCams"),
                       (["--steps", "1-9"], "item 6"),
                       (["--steps", "9"], "item 6")):
        with pytest.raises(NotImplementedError, match=what):
            TM.main(["--data-root", root, "--device", "cpu"] + argv)
    for argv, what in ((["--sim"], "One-pixel_DE"),
                       (["--sim", "--attackers", "One-pixel_DE"], "item 6"),
                       (["--attackers", "SPAA", "--multi-setup-train"],
                        "item 7"),
                       (["--multi-setup-attack"], "item 7")):
        with pytest.raises(NotImplementedError, match=what):
            TR.main(["--data-root", root, "--device", "cpu"] + argv)
    assert not os.listdir(root), "nothing may run before the raise"
    assert TM.parse_args([]).device == TR.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.main(["--data-root", root, "--steps", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.main(["--data-root", root, "--attackers", "SPAA"])
