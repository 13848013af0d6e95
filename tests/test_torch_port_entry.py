"""Port entry points: ``spaa_tpu_torch.main`` and
``spaa_tpu_torch.reproduce_paper_results`` on the CPU at tiny sizes.

One module fixture runs ``main --steps 1-8`` (sim 32x32 projector, 32x24
camera, 8 training pairs, 3 PCNet / CompenNet++ iterations, 2 attack
iterations, ResNet-18, SPAA with one loss and one threshold, then
PerC-AL+CompenNet++); both packages read one ``.pth`` made from
``spaa_tpu``'s seeded parameters. Then:

- SPAA's reference layout and 71-column table, equal to what
  ``spaa_tpu``'s ``summarize_single_attacker`` makes of the port's PNGs;
  ``main --steps 1,2,9,10 --op-budget 21 1 8 6`` adds One-pixel DE and the
  three-attacker ``stats_all`` and pivot, and ``reproduce_paper_results
  --sim --summarize-only`` runs the default list of all three attackers;
- ``reproduce_paper_results --sim --summarize-only`` on a synthetic
  ``sim_benchmark`` tree writes ``stats_all``, the pivot and the phase
  JSON;
- PerC-AL+CompenNet++'s layout, checkpoints and 71-column row; then
  ``reproduce_paper_results --summarize-only`` without ``--sim`` runs its
  default list (SPAA and PerC-AL);
- the flags of the paths ported last (``--multi-setup-*``, ``--hardware``)
  parse and stop before any work where there is nothing to run them on,
  and both entry points default to ``cuda`` (the multi-setup paths are
  run in ``tests/test_torch_port_parallel.py``, the hardware in
  ``tests/test_torch_port_procams_hw.py``).
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
PCFG = to_attacker_cfg_str("PerC-AL+CompenNet++")[0]
SIM_ARGS = ["--setup-name", "sim_setup", "--device", "cpu", "--sim-size",
            "32", "32", "32", "24", "--num-train", "8", "--classifiers",
            "resnet18"]


def _weights(tmp_path):
    w = tmp_path / "weights"
    w.mkdir()
    params = jax.tree.map(np.asarray, init_params("resnet18", seed=0))
    torch.save(resnet18_state_dict(params), w / "resnet18-5c106cde.pth")
    return str(w)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """``main --steps 1-8`` in ``<tmp>/sim_benchmark``: SPAA, then
    PerC-AL+CompenNet++."""
    tmp = tmp_path_factory.mktemp("entry")
    weights = _weights(tmp)
    data = str(tmp / "sim_benchmark")
    TM.main(["--data-root", data, "--steps", "1-8"] + SIM_ARGS
            + ["--train-iters", "3", "--attack-iters", "2",
               "--stealth-losses", "caml2", "--d-threshes", "5",
               "--weights-dir", weights])
    return tmp, data, weights


def test_main_steps_1_to_7_and_10_on_cpu(main_run, tmp_path):
    tmp, data, weights = main_run
    setup = join(data, "setups", "sim_setup")
    folder = join(CFG, "caml2", "5", "resnet18")
    for sub in ("prj/adv", "cam/infer/adv", "cam/raw/adv", "ret"):
        assert len(glob.glob(join(setup, sub, folder, "img_*.png"))) == 11
    assert len(os.listdir(join(data, "setups/sync_test/cam/raw/numbers"))) \
        == 10
    for f in ("stats.txt", "stats.xlsx"):
        assert os.path.exists(join(setup, "ret", CFG, f))
    assert glob.glob(join(data, "..", "log", "*.xlsx"))
    got = pd.read_csv(join(setup, "ret", CFG, "stats.txt"), sep="\t")
    assert got.shape == (1, 71)

    # spaa_tpu summarizes the port's PNGs: the same table
    jroot = str(tmp_path / "jax")
    shutil.copytree(data, jroot)
    shutil.rmtree(join(jroot, "setups/sim_setup/ret"))
    JS.summarize_single_attacker("SPAA", jroot, ["sim_setup"],
                                 weights_dir=weights,
                                 classifier_names=["resnet18"],
                                 stealth_losses=["caml2"], d_threshes=[5])
    want = pd.read_csv(join(jroot, "setups/sim_setup/ret", CFG, "stats.txt"),
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

    # step 9 (One-pixel DE through the simulator), then step 10 gathers
    # the three attackers
    root = tmp_path / "sim_benchmark"
    shutil.copytree(data, root)
    TM.main(["--data-root", str(root), "--steps", "1,2,9,10"] + SIM_ARGS
            + ["--op-budget", "21", "1", "8", "6", "--weights-dir", weights])
    setup = join(root, "setups", "sim_setup")
    ofolder = join("One-pixel_DE", "-", "-", "resnet18")
    for sub in ("prj/adv", "cam/raw/adv", "ret"):
        assert len(glob.glob(join(setup, sub, ofolder, "img_*.png"))) == 11
    assert not os.path.exists(join(setup, "cam/infer/adv", "One-pixel_DE"))
    row = pd.read_csv(join(setup, "ret/One-pixel_DE/stats.txt"), sep="\t")
    assert row.shape == (1, 71) and list(row["d_thr"]) == ["-"]
    stats = pd.read_csv(join(root, "setups/stats_all.txt"), sep="\t")
    assert stats.shape == (3, 71)
    assert list(stats["Attacker"]) == [CFG, PCFG, "One-pixel_DE"]
    for f in ("stats_all.xlsx", "pivot_table_all.xlsx"):
        assert os.path.exists(join(root, "setups", f))
    pivot = read_xlsx(join(root, "setups/pivot_table_all.xlsx"))
    assert len(pivot) == 4
    assert {r[0] for r in pivot[1:]} == {CFG, PCFG, "One-pixel_DE"}

    # the --sim default list is all three attackers; summarize's full grid
    # stops a row at its first missing classifier (inception_v3 <
    # resnet18): One-pixel's ResNet-18 images stand in for it
    for sub in ("prj/adv", "cam/raw/adv"):
        shutil.copytree(join(setup, sub, ofolder), join(
            setup, sub, "One-pixel_DE", "-", "-", "inception_v3"))
    phase_json = str(tmp_path / "phases.json")
    TR.main(["--sim", "--data-root", str(tmp_path), "--summarize-only",
             "--device", "cpu", "--weights-dir", weights, "--phase-json",
             phase_json])
    rec = json.load(open(phase_json))
    assert rec["attackers"] == ["SPAA", "PerC-AL+CompenNet++",
                                "One-pixel_DE"]
    assert rec["stats_all_rows"] == 2


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


def test_main_step_8_and_the_default_attackers_on_cpu(main_run, tmp_path):
    """Step 8 of the fixture (PerC-AL+CompenNet++: CompenNet pre-trained
    and CompenNet++ trained 3 iterations, PerC-AL 2 iterations, ResNet-18,
    its one (camdE, 11) config), then ``reproduce_paper_results
    --summarize-only`` with the default attacker list (SPAA and PerC-AL
    without ``--sim``)."""
    tmp, data, weights = main_run
    setup = join(data, "setups", "sim_setup")
    folder = join(PCFG, "camdE", "11", "resnet18")
    for sub in ("prj/adv", "cam/infer/adv", "cam/raw/adv", "ret"):
        assert len(glob.glob(join(setup, sub, folder, "img_*.png"))) == 11
    assert os.path.exists(join(data, "..", "checkpoint",
                               "init_CompenNet_l1+ssim_500_48_500_0.001_0.2_"
                               "800_0.0001.flax"))
    assert len(os.listdir(join(setup, "prj/infer/test",
                               "CompenNet++_l1+ssim_8_8_3"))) == 3
    got = pd.read_csv(join(setup, "ret", PCFG, "stats.txt"), sep="\t")
    assert got.shape == (1, 71)
    assert list(got["Stealth_loss"]) == ["camdE"] and list(got["d_thr"]) \
        == [11]

    # summarize's full grid stops a row at its first missing classifier
    # (inception_v3 < resnet18): the ResNet-18 images stand in for it
    root = str(tmp_path / "data")
    shutil.copytree(data, root)
    setup = join(root, "setups", "sim_setup")
    for sub in ("prj/adv", "cam/infer/adv", "cam/raw/adv"):
        shutil.copytree(join(setup, sub, folder), join(
            setup, sub, PCFG, "camdE", "11", "inception_v3"))
    phase_json = str(tmp_path / "phases.json")
    TR.main(["--data-root", root, "--setups", "sim_setup", "--summarize-only",
             "--device", "cpu", "--weights-dir", weights, "--phase-json",
             phase_json])
    rec = json.load(open(phase_json))
    assert rec["attackers"] == ["SPAA", "PerC-AL+CompenNet++"]
    assert rec["stats_all_rows"] == 2
    pivot = read_xlsx(join(root, "setups/pivot_table_all.xlsx"))
    assert len(pivot) == 3 and {r[0] for r in pivot[1:]} == {PCFG}


def test_unported_paths_raise_and_cuda_is_the_default(tmp_path):
    """Nothing is left unported: ``--hardware`` and the ``--multi-setup-*``
    flags parse; without a ``setup_info.yml`` the hardware path stops
    before it opens a device, and without setups the multi-setup flags
    stop before any work."""
    root = str(tmp_path)
    args = TM.parse_args(["--hardware", "--cam-index", "1", "--prj-offset",
                          "0", "0"])
    assert args.hardware and args.cam_index == 1 and args.prj_offset == [0, 0]
    args = TR.parse_args(["--multi-setup-train", "--multi-setup-chunk", "2",
                          "--multi-setup-attack"])
    assert args.multi_setup_train and args.multi_setup_attack
    assert args.multi_setup_chunk == 2
    assert TR.parse_args([]).multi_setup_chunk is None
    for argv in (["--hardware"], ["--hardware", "--steps", "9"]):
        with pytest.raises(SystemExit, match="--steps 1 first"):
            TM.main(["--data-root", root, "--device", "cpu"] + argv)
    for argv in (["--multi-setup-train"],
                 ["--attackers", "SPAA", "--multi-setup-train",
                  "--multi-setup-chunk", "2"],
                 ["--multi-setup-attack"]):
        with pytest.raises(SystemExit, match="No setups"):
            TR.main(["--data-root", root, "--device", "cpu"] + argv)
    assert not os.listdir(root), "nothing may run before the stop"
    assert TM.parse_args([]).device == TR.parse_args([]).device == "cuda"
    assert TM.parse_args(["--op-budget", "21", "1", "8", "6"]).op_budget \
        == [21, 1, 8, 6]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.main(["--data-root", root, "--steps", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.main(["--data-root", root, "--attackers", "SPAA"])
