"""Port parity: ``SimProCams`` without OpenCV.

- ``make_setup`` at 64x64 and at the default size (a few pairs) against
  ``spaa_tpu``'s: every PNG within 1 uint8 count, ``setup_info.yml``
  byte-equal, the direct-light footprint equal;
- the numpy twins of ``cv2.resize`` (bicubic, nearest), of
  ``getAffineTransform`` and of ``warpAffine`` against cv2 on odd sizes;
- the default-size ``cam/raw/{ref,cb}`` against the committed fixture:
  within 1 count, with the same mask and corners.
"""

import os
from os.path import join

import cv2
import numpy as np
import pytest

from spaa_tpu.utils.sim_procams import SimProCams as JaxSimProCams
from spaa_tpu_torch.train.data import nayar_separation
from spaa_tpu_torch.utils import sim_procams as S
from spaa_tpu_torch.utils.imgproc_host import threshold_im
from spaa_tpu_torch.utils.io import imread_dir, imread_u8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = join(REPO, "spaa_tpu_torch", "assets", "sim_setup")
SMALL = dict(prj_im_sz=[64, 64], cam_im_sz=[64, 48],
             classifier_crop_sz=[48, 48])


def _files(root):
    return sorted(os.path.relpath(join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """kind -> (setup info, spaa_tpu's root, the port's root, port sim)."""
    out = {}
    for kind in ("small", "default"):
        info = dict(S.DEFAULT_SIM_SETUP_INFO)
        if kind == "small":
            info.update(SMALL)
        root = tmp_path_factory.mktemp(kind)
        JaxSimProCams(info, seed=7).make_setup(str(root / "jax"), "s",
                                               num_train=5, num_test=3)
        port = S.SimProCams(info, seed=7)
        port.make_setup(str(root / "port"), "s", num_train=5, num_test=3)
        out[kind] = (info, root / "jax", root / "port", port)
    return out


@pytest.mark.parametrize("kind", ["small", "default"])
def test_make_setup_matches_spaa_tpu(built, kind):
    info, jroot, proot, port = built[kind]
    files = _files(jroot)
    assert files == _files(proot) and len(files) == 29
    n_diff = 0
    for rel in files:
        if rel.endswith(".png"):
            a = imread_u8(str(jroot / rel)).astype(np.int16)
            b = imread_u8(str(proot / rel)).astype(np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel
            n_diff += int((a != b).sum())
        else:
            assert (jroot / rel).read_bytes() == (proot / rel).read_bytes()
    # float32 rounding of the warp's source coordinates: a handful of
    # values sit on a quantisation step of the uint8 PNG
    assert n_diff < 200, n_diff
    np.testing.assert_array_equal(port.footprint,
                                  JaxSimProCams(info, seed=7).footprint)


@pytest.mark.parametrize("src_hw,dst_wh", [((30, 40), (320, 240)),
                                           ((7, 9), (33, 50)),
                                           ((16, 16), (256, 256))])
def test_resize_matches_cv2(src_hw, dst_wh):
    src = np.random.default_rng(0).random((*src_hw, 3)).astype(np.float32)
    want = cv2.resize(src, dst_wh, interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(S.resize_cubic(src, dst_wh), want, rtol=0,
                               atol=2e-6)
    lab = (np.arange(src.size // 3).reshape(src_hw) % 7).astype(np.float32)
    np.testing.assert_array_equal(
        S.resize_nearest(lab, dst_wh),
        cv2.resize(lab, dst_wh, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("prj,cam", [((256, 256), (320, 240)),
                                     ((37, 29), (50, 41))])
def test_affine_warp_matches_cv2(prj, cam):
    (pw, ph), (w, h) = prj, cam
    dst = np.float32([[int(0.15 * w), int(0.12 * h)],
                      [w - int(0.15 * w), int(0.12 * h)],
                      [w - int(0.15 * w), h - int(0.12 * h)]])
    src = np.float32([[0, 0], [pw - 1, 0], [pw - 1, ph - 1]])
    m = S.get_affine_transform(src, dst)
    np.testing.assert_array_equal(m, cv2.getAffineTransform(src, dst))
    im = np.random.default_rng(1).random((ph, pw, 3)).astype(np.float32)
    warp = S.AffineWarp(m, (ph, pw), (w, h))
    np.testing.assert_allclose(warp(im),
                               cv2.warpAffine(im, m, (w, h),
                                              flags=cv2.INTER_LINEAR),
                               rtol=0, atol=3e-5)
    ones = np.ones((ph, pw), np.float32)
    np.testing.assert_array_equal(warp(ones) > 0.5,
                                  cv2.warpAffine(ones, m, (w, h)) > 0.5)


def test_default_setup_matches_committed_fixture(built):
    setup = built["default"][2] / "setups" / "s"
    for sub in ("cam/raw/ref", "cam/raw/cb"):
        for f in sorted(os.listdir(join(FIXTURE, sub))):
            a = imread_u8(join(FIXTURE, sub, f)).astype(np.int16)
            b = imread_u8(str(setup / sub / f)).astype(np.int16)
            assert np.abs(a - b).max() <= 1, (sub, f)
    got = threshold_im(nayar_separation(imread_dir(str(setup / "cam/raw/cb")))[0])
    want = threshold_im(nayar_separation(imread_dir(join(FIXTURE,
                                                         "cam/raw/cb")))[0])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2]
