"""Port parity: the montage helpers of ``spaa_tpu_torch`` against
``spaa_tpu``'s OpenCV and Pillow ones.

- the JET table equals ``cv2.applyColorMap`` for all 256 inputs;
- ``insert_texts`` equals ``spaa_tpu``'s Pillow rendering byte for byte
  for the first name of every one of the 1000 ImageNet labels and the
  montage's fixed strings, at the label positions of a montage and past
  the image's edges;
- ``attack_results`` draws the same strings as ``spaa_tpu``'s and its
  montage agrees within 1 count on a seeded cell;
- the tools that made the committed glyph atlas and JET table make them
  again.
"""

import json
import os
import subprocess
import sys
from os.path import join

import cv2
import numpy as np
import pytest

from spaa_tpu.attack import summarize as JS
from spaa_tpu.utils import imgproc_host as JH
from spaa_tpu_torch.attack import summarize as TS
from spaa_tpu_torch.ops.image import center_crop
from spaa_tpu_torch.utils import imgproc_host as TH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, join(REPO, "tools"))
import make_torch_font_atlas  # noqa: E402
import make_torch_jet_table  # noqa: E402

FIXED = ["Cam-captured scene (7)", "Model inferred adversarial projection",
         "Model inferred cam-captured projection",
         "Real cam-captured projection",
         "Normalized difference, i.e., 4th-1st", "L2=12.34", "L2=0.07"]


def test_jet_table_equals_cv2():
    x = np.arange(256, dtype=np.uint8)[:, None]
    want = cv2.cvtColor(cv2.applyColorMap(x, cv2.COLORMAP_JET),
                        cv2.COLOR_BGR2RGB)[:, 0]
    np.testing.assert_array_equal(TH._jet(), want)
    rng = np.random.default_rng(0)
    for shape in ((16, 16), (1, 7, 9)):
        im = rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(TH.to_pseudocolor(im),
                                      JH.to_pseudocolor(im))


@pytest.mark.parametrize("font_sz", [8, 14])
def test_insert_texts_equals_pillow_for_every_label(font_sz):
    names = make_torch_font_atlas.label_names(REPO)
    assert len(names) == 1000
    rng = np.random.default_rng(font_sz)
    base = (rng.random((24, 200, 3)) * 255).astype(np.uint8)
    strings = [f"{n} ({p:.2f})" for n, p in zip(
        names, rng.random(len(names)))] + names + FIXED
    for k in range(0, len(strings), 4):
        items = [(s, (int(rng.integers(-20, 180)), int(rng.integers(-6, 16))),
                  tuple(int(c) for c in rng.integers(0, 256, 3)))
                 for s in strings[k:k + 4]]
        want = JH.insert_texts(base, items, font_sz, border=(0, 12, 0, 0),
                               as_uint8=True)
        got = TH.insert_texts(base, items, font_sz, border=(0, 12, 0, 0),
                              as_uint8=True)
        assert np.array_equal(got, want), items
    # float in, float out; and the sync-test pattern drawn at size h // 2
    f = rng.random((20, 60, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TH.insert_text(f, "tench", (3, 4), font_sz, (255, 0, 0)),
        JH.insert_text(f, "tench", (3, 4), font_sz, (255, 0, 0)))
    np.testing.assert_array_equal(TH.create_number_pattern(32, 24),
                                  JH.create_number_pattern(32, 24))


def test_font_atlas_refuses_uncovered_sizes_and_glyphs():
    meta, _ = TH._atlas()
    assert meta["font"] == "Aileron Regular" and meta["pixel_size"] == 10
    with pytest.raises(ValueError, match="does not cover size 300"):
        TH.insert_texts(np.zeros((4, 4, 3), np.uint8), [("a", (0, 0),
                                                         (0, 0, 0))], 300)
    with pytest.raises(ValueError, match="no glyph"):
        TH.insert_texts(np.zeros((4, 4, 3), np.uint8), [("é", (0, 0),
                                                         (0, 0, 0))], 14)


def test_montage_helpers_match():
    rng = np.random.default_rng(1)
    imgs = rng.random((7, 5, 6, 3)).astype(np.float32)
    for fn in ("make_grid", "make_grid_transposed"):
        np.testing.assert_array_equal(getattr(TH, fn)(imgs, 3, 2, 0.5),
                                      getattr(JH, fn)(imgs, 3, 2, 0.5))
    np.testing.assert_array_equal(TH.montage(imgs), JH.montage(imgs))
    np.testing.assert_array_equal(TH.expand_border(imgs[0]),
                                  JH.expand_border(imgs[0]))
    np.testing.assert_array_equal(TH.create_gray_pattern(40, 24),
                                  JH.create_gray_pattern(40, 24))
    np.testing.assert_allclose(TH.resize_area_np(imgs, (3, 4)),
                               JH.resize_area_np(imgs, (3, 4)), atol=2e-7)


def _seeded_cell(prj):
    rng = np.random.default_rng(prj)
    cam_h, cam_w, crop = (24, 32, 16) if prj == 16 else (240, 320, 240)
    m = 11
    scene = rng.random((1, cam_h, cam_w, 3)).astype(np.float32)
    ci = (rng.random((m, cam_h, cam_w, 3)) * 255).astype(np.uint8)
    cr = (rng.random((m, cam_h, cam_w, 3)) * 255).astype(np.uint8)
    pa = (rng.random((m, prj, prj, 3)) * 255).astype(np.uint8)
    gray = np.full((1, prj, prj, 3), 0.5, np.float32)
    p = np.sort(rng.random((m, 1000)).astype(np.float32), 1)[:, ::-1]
    idx = np.stack([rng.permutation(1000) for _ in range(m)])
    ret = {"scene": (None, p[:1], idx[:1]), "infer": (None, p, idx),
           "real": (None, p[::-1].copy(), idx[::-1].copy())}
    return scene, ci, cr, pa, gray, ret, (crop, crop)


@pytest.mark.parametrize("prj", [16, 256])
def test_montage_panels_match_spaa_tpu(prj):
    scene, ci, cr, pa, gray, _, cp = _seeded_cell(prj)
    want = JS.montage_panels(scene, ci, cr, pa, gray, cp, [prj, prj])
    got = TS.montage_panels(scene, ci, cr, pa, gray, cp, [prj, prj],
                            device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prj", [16, 256])
def test_attack_results_matches_spaa_tpu(monkeypatch, prj):
    """One seeded cell through both packages' ``attack_results`` as
    summarize calls it (panels resized on the host by each package's
    ``resize_area_np``, L2s from its ``montage_panels``): the same strings
    at the same places, and the montage within 1 count."""
    scene, ci, cr, pa, gray, ret, cp = _seeded_cell(prj)
    with open(join(REPO, "data", "imagenet1000_clsidx_to_labels.json")) as f:
        labels = {int(k): v.split(",")[0] for k, v in json.load(f).items()}
    drawn = {}
    for key, mod in (("jax", JS), ("port", TS)):
        orig = mod.insert_texts

        def spy(im, items, *a, _orig=orig, _key=key, **kw):
            drawn[_key] = list(items)
            return _orig(im, items, *a, **kw)

        monkeypatch.setattr(mod, "insert_texts", spy)

    def host_panels(H, S, **kw):
        def rz(x):
            x = center_crop(x, cp)
            return H.resize_area_np(x.astype(np.float32) / 255.0
                                    if x.dtype == np.uint8 else x, (prj, prj))
        l2s = S.montage_panels(scene, ci, cr, pa, gray, cp, [prj, prj],
                               **kw)[3:]
        return (rz(scene)[0], rz(ci), rz(cr), *l2s)

    panels = {"jax": host_panels(JH, JS),
              "port": host_panels(TH, TS, device="cpu")}
    for t in (0, 4, 10):
        want = JS.attack_results(ret, t, labels, gray, pa, scene, None,
                                 None, [prj, prj], cp, panels=panels["jax"],
                                 as_uint8=True)
        got = TS.attack_results(ret, t, labels, pa, [prj, prj],
                                panels["port"])
        assert drawn["port"] == drawn["jax"]
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(np.int16) - want).max() <= 1


def test_tools_reproduce_committed_assets(tmp_path):
    out = tmp_path / "atlas.npz"
    subprocess.run([sys.executable, join(REPO, "tools",
                                         "make_torch_font_atlas.py"),
                    "--out", str(out)], check=True, cwd=REPO,
                   capture_output=True, timeout=300)
    with np.load(out) as new, np.load(TH.FONT_ATLAS) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    np.testing.assert_array_equal(make_torch_jet_table.jet_table(),
                                  np.load(TH.JET_TABLE))
