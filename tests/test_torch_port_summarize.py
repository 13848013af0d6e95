"""Port parity: ``spaa_tpu_torch.attack.summarize`` and the replay against
``spaa_tpu``, on the synthetic result tree of ``tests/test_summarize.py``
(projector 16, camera 24x32, crop 16; ResNet-18 only, both packages
reading the same ``.pth`` made from ``spaa_tpu``'s seeded parameters).

Both packages summarize their own copy of the tree. The stats tables must
agree: text and integer cells, row order and success rates equal,
numeric cells within 2e-4 + 1e-5|x| of the ``%.4f`` text; the montages
are the same files, decoded within 1 count; ``pivot_table_all.xlsx``
agrees to the same tolerance. The port also repeats
``test_summarize.py``'s regression cases."""

import glob
import os
import shutil
import time
from os.path import join

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from spaa_tpu.attack import orchestrate as JO
from spaa_tpu.attack import summarize as JS
from spaa_tpu.models.classifiers import init_params
from spaa_tpu.utils import procams as JP
from spaa_tpu.utils.sim_procams import DEFAULT_SIM_SETUP_INFO
from spaa_tpu.utils.sim_procams import SimProCams as JaxSim
from spaa_tpu.utils.xlsx import read_xlsx as j_read_xlsx
from spaa_tpu_torch.attack import orchestrate as TO
from spaa_tpu_torch.attack import summarize as TS
from spaa_tpu_torch.utils import procams as TP
from spaa_tpu_torch.utils.io import imread_u8, save_imgs
from spaa_tpu_torch.utils.sim_procams import SimProCams as PortSim
from spaa_tpu_torch.utils.xlsx import read_xlsx
from spaa_tpu_torch.weights import resnet18_state_dict
from test_summarize import _write_setup

CFG = JO.to_attacker_cfg_str("SPAA")[0]
KW = dict(classifier_names=["resnet18"], stealth_losses=["caml2"],
          d_threshes=[5, 7])
RATES = ["T.top-1_infer", "T.top-5_infer", "T.top-1_real", "T.top-5_real",
         "U.top-1_infer", "U.top-1_real"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The result tree (s1: one complete cell; s2: one complete and one
    incomplete), a copy for each package, and the shared weights."""
    tmp = tmp_path_factory.mktemp("sumport")
    base = str(tmp / "base")
    rng = np.random.default_rng(7)
    _write_setup(base, "s1", [("caml2", 5, "resnet18", None)], rng)
    _write_setup(base, "s2", [("caml2", 5, "resnet18", None),
                              ("caml2", 7, "resnet18", 5)], rng)
    weights = tmp / "weights"
    weights.mkdir()
    params = jax.tree.map(np.asarray, init_params("resnet18", seed=0))
    torch.save(resnet18_state_dict(params), weights / "resnet18-5c106cde.pth")
    roots = {}
    for k in ("jax", "port"):
        roots[k] = str(tmp / k)
        shutil.copytree(base, roots[k])
    JS.summarize_single_attacker("SPAA", roots["jax"], ["s1", "s2"],
                                 weights_dir=str(weights), **KW)
    TS.summarize_single_attacker("SPAA", roots["port"], ["s1", "s2"],
                                 weights_dir=str(weights), device="cpu", **KW)
    return roots, str(weights)


def _assert_tables_close(want: pd.DataFrame, got: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        w, g = want[col].tolist(), got[col].tolist()
        if col in RATES or not all(isinstance(v, float) for v in w):
            assert g == w, col
        else:
            w, g = np.asarray(w), np.asarray(g)
            tol = 2e-4 + 1e-5 * np.abs(w)
            # identical images: PSNR inf here, ~150 dB from spaa_tpu's
            # jitted x / 255 (test_torch_port_entry.py)
            same = np.isinf(g) & (w >= 120) if col.endswith("PSNR") else g != g
            assert np.all((np.abs(g - w) <= tol) | same), (col, w, g)


def _assert_xlsx_close(want_path, got_path):
    got, want = read_xlsx(got_path), j_read_xlsx(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    for w_row, g_row in zip(want[1:], got[1:]):
        assert len(g_row) == len(w_row)
        for w, g in zip(w_row, g_row):
            if isinstance(w, float) or isinstance(g, float):
                assert abs(g - w) <= 2e-4 + 1e-5 * abs(w), (w, g)
            else:
                assert g == w
    return got


def test_stats_tables_match_spaa_tpu(trees):
    roots, _ = trees
    for s in ("s1", "s2"):
        paths = [join(roots[k], "setups", s, "ret", CFG, "stats.txt")
                 for k in ("jax", "port")]
        want, got = (pd.read_csv(p, sep="\t") for p in paths)
        assert len(want.columns) == 71
        assert list(got["Setup"]) == [s]          # own rows only
        _assert_tables_close(want, got)
        _assert_xlsx_close(*(join(roots[k], "setups", s, "ret", CFG,
                                  "stats.xlsx") for k in ("jax", "port")))


def test_montages_match_spaa_tpu(trees):
    roots, _ = trees
    pngs = {k: sorted(os.path.relpath(p, roots[k]) for p in glob.glob(
        join(roots[k], "setups/*/ret/**/img_*.png"), recursive=True))
        for k in roots}
    assert pngs["port"] == pngs["jax"] and len(pngs["jax"]) == 22
    for rel in pngs["jax"]:
        a = imread_u8(join(roots["jax"], rel)).astype(np.int16)
        b = imread_u8(join(roots["port"], rel)).astype(np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel


def test_summarize_all_and_pivot_match_spaa_tpu(trees):
    roots, weights = trees
    JS.summarize_all_attackers(["SPAA"], roots["jax"], ["s1", "s2"])
    table, pivot = TS.summarize_all_attackers(["SPAA"], roots["port"],
                                              ["s1", "s2"])
    assert sorted(table["Setup"]) == ["s1", "s2"]
    want, got = (pd.read_csv(join(roots[k], "setups/stats_all.txt"),
                             sep="\t") for k in ("jax", "port"))
    _assert_tables_close(want, got)
    got = _assert_xlsx_close(*(join(roots[k], "setups/pivot_table_all.xlsx")
                               for k in ("jax", "port")))
    assert got[0] == TS.PIVOT_INDEX + TS.PIVOT_VALUES and len(got) == 2


def test_incomplete_cell_is_skipped(trees):
    roots, weights = trees
    df = TS.summarize_single_attacker("SPAA", roots["port"], ["s2"],
                                      weights_dir=weights, device="cpu", **KW)
    assert len(df) == 1 and df["d_thr"] == [5]


def test_recreate_imgs_false_skips_existing_montages(trees):
    roots, weights = trees
    pngs = sorted(glob.glob(join(roots["port"], "setups/s1/ret/**/img_*.png"),
                            recursive=True))
    assert len(pngs) == 11
    before = {p: os.path.getmtime(p) for p in pngs}
    stats = join(roots["port"], "setups/s1/ret", CFG, "stats.txt")
    stats_before = os.path.getmtime(stats)
    time.sleep(0.05)
    df = TS.summarize_single_attacker("SPAA", roots["port"], ["s1"],
                                      weights_dir=weights, device="cpu",
                                      recreate_imgs=False, **KW)
    assert len(df) == 1
    assert os.path.getmtime(stats) > stats_before
    assert before == {p: os.path.getmtime(p) for p in pngs}


def test_replay_matches_spaa_tpu(tmp_path):
    """``project_capture_real_attack`` of both packages on the same
    ``prj/adv`` PNGs: captures within 1 count."""
    info = dict(DEFAULT_SIM_SETUP_INFO)
    info.update(prj_im_sz=[16, 16], cam_im_sz=[32, 24],
                classifier_crop_sz=[16, 16])
    base = str(tmp_path / "base")
    _write_setup(base, "vtest", [("caml2", 5, "resnet18", None),
                                 ("camdE", 5, "resnet18", None)],
                 np.random.default_rng(3))
    roots = {}
    for k, mod, sim in (("jax", JO, JaxSim), ("port", TO, PortSim)):
        roots[k] = str(tmp_path / k)
        shutil.copytree(base, roots[k])
        shutil.rmtree(join(roots[k], "setups/vtest/cam/raw/adv"))
        cfg = mod.get_attacker_cfg("SPAA", roots[k], ["vtest"])
        cfg.classifier_names = ["resnet18"]
        cfg.stealth_losses = ["caml2", "camdE"]
        cfg.d_threshes = [5]
        mod.project_capture_real_attack(cfg, sim(info))
    got = sorted(glob.glob(join(roots["port"], "setups/vtest/cam/raw/adv/**/"
                                "*.png"), recursive=True))
    assert len(got) == 22
    for p in got:
        q = p.replace(roots["port"], roots["jax"])
        d = np.abs(imread_u8(p).astype(np.int16)
                   - imread_u8(q).astype(np.int16))
        assert d.max() <= 1, p


def test_capture_workflows_match_spaa_tpu(tmp_path):
    """``capture_setup_data`` and ``sync_test`` of both packages through
    their simulators: the same projected patterns and captures, within 1
    count."""
    info = dict(DEFAULT_SIM_SETUP_INFO)
    info.update(prj_im_sz=[16, 16], cam_im_sz=[32, 24],
                classifier_crop_sz=[16, 16])
    rng = np.random.default_rng(4)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    for sub, n in (("train", 3), ("test", 2)):
        ims = rng.random((n, 16, 16, 3)).astype(np.float32)
        for root in roots.values():
            save_imgs(ims, join(root, "prj_share", sub))
    for k, mod, sim in (("jax", JP, JaxSim), ("port", TP, PortSim)):
        mod.capture_setup_data(sim(info), roots[k], "vtest")
        mod.sync_test(sim(info), roots[k])
    got = sorted(os.path.relpath(p, roots["port"]) for p in glob.glob(
        join(roots["port"], "**/*.png"), recursive=True))
    want = sorted(os.path.relpath(p, roots["jax"]) for p in glob.glob(
        join(roots["jax"], "**/*.png"), recursive=True))
    assert got == want and len(got) > 40
    for rel in got:
        d = np.abs(imread_u8(join(roots["port"], rel)).astype(np.int16)
                   - imread_u8(join(roots["jax"], rel)).astype(np.int16))
        assert d.max() <= 1, rel
