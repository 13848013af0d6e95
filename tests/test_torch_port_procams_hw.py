"""Port parity: the hardware half of ``utils/procams.py`` and ``main
--hardware`` against ``spaa_tpu``'s, under the fake camera and the Agg
matplotlib backend of ``tests/test_procams_hw.py``.

Both packages' ``init_cam`` and ``preview_cam``, ``HardwareProCams``'
``capture``, ``adjust_setup_brightness_and_pose`` and ``release``,
``project_capture_data`` on its shared-window and own-window branches,
``capture_setup_data`` and ``sync_test`` run against the same fakes: the
same camera settings and reads, the same file trees, the decoded PNGs
equal. The port's ``main --hardware --steps 1,2`` writes the tree the root
``main.py`` writes. ``spaa_tpu_torch.utils.procams`` and ``main`` import
with ``cv2`` and ``matplotlib`` unavailable.
"""

import importlib.util
import os
import subprocess
import sys
from os.path import join

import matplotlib

matplotlib.use("Agg", force=True)

import cv2
import numpy as np
import pytest

import spaa_tpu.utils.procams as JPC
import spaa_tpu_torch.utils.procams as TPC
from spaa_tpu_torch import main as TM
from spaa_tpu_torch.utils.config import save_flat_yaml
from spaa_tpu_torch.utils.io import imread_u8, save_imgs
from test_procams_hw import SETUP_INFO, FakeVideoCapture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (("jax", JPC), ("port", TPC))


@pytest.fixture
def hw(monkeypatch, tmp_path):
    """The device layer faked for both packages (they share the ``cv2`` and
    ``time`` modules); resize, cvtColor and imwrite stay real."""
    FakeVideoCapture.instances = []
    monkeypatch.setattr(cv2, "VideoCapture", FakeVideoCapture)
    monkeypatch.setattr(cv2, "imshow", lambda *a, **k: None)
    monkeypatch.setattr(cv2, "waitKey", lambda *a, **k: ord("q"))
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda *a, **k: None)
    monkeypatch.setattr(JPC.time, "sleep", lambda *_: None)
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "pause", lambda *_: None)
    yield str(tmp_path)
    plt.close("all")


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                p = join(d, f)
                out[os.path.relpath(p, root)] = imread_u8(p)
    return out


def _assert_same_trees(a, b):
    ta, tb = _tree(a), _tree(b)
    assert ta and sorted(ta) == sorted(tb)
    for k, v in ta.items():
        assert np.array_equal(v, tb[k]), k


def test_init_cam_and_preview_match(hw):
    seen = {}
    for name, mod in PACKAGES:
        FakeVideoCapture.instances = []
        cam = mod.init_cam(SETUP_INFO["cam_raw_sz"], index=3)
        mod.preview_cam(SETUP_INFO["cam_raw_sz"], (800, 600), cam=cam)
        assert not cam.released, "a shared camera stays open"
        mod.preview_cam(SETUP_INFO["cam_raw_sz"], (32, 24))
        own = FakeVideoCapture.instances[-1]
        assert own.released, "an own preview releases its camera"
        seen[name] = (cam.index, cam.props, cam.reads, own.props, own.reads)
    assert seen["port"] == seen["jax"]
    im = np.arange(48 * 64 * 3, dtype=np.uint8).reshape(48, 64, 3)
    for size in ((32, 24), (800, 600), (63, 47)):
        assert np.array_equal(TPC._center_crop_np(im, size),
                              JPC._center_crop_np(im, size))


def test_capture_adjust_and_release_match(hw):
    import matplotlib.pyplot as plt
    ims = {}
    for name, mod in PACKAGES:
        pc = mod.HardwareProCams(SETUP_INFO)
        ims[name] = [pc.capture(np.full((16, 16, 3), 0.6, np.float32)),
                     pc.capture()]
        n_before = len(plt.get_fignums())
        mod.adjust_setup_brightness_and_pose(pc)
        assert len(plt.get_fignums()) == n_before, \
            "the brightness windows close, the projector window stays"
        pc.release()
        assert pc.cam.released and not plt.get_fignums()
    h, w = SETUP_INFO["cam_im_sz"][1], SETUP_INFO["cam_im_sz"][0]
    for a, b in zip(ims["port"], ims["jax"]):
        assert a.shape == (h, w, 3) and a.dtype == np.float32
        assert np.array_equal(a, b)


def test_project_capture_data_both_branches_match(hw):
    prj_dir = join(hw, "prj_in")
    save_imgs(np.random.default_rng(0).random((3, 16, 16, 3)), prj_dir)
    reads = {}
    for name, mod in PACKAGES:
        pc = mod.HardwareProCams(SETUP_INFO)
        pc.project_capture_data(prj_dir, join(hw, name, "cap_shared"))
        pc.release()
        mod.project_capture_data(prj_dir, join(hw, name, "cap_owned"),
                                 SETUP_INFO)
        own = FakeVideoCapture.instances[-1]
        assert own.released and own.reads == 100 + 3 * 2
        reads[name] = (pc.cam.reads, own.reads)
    assert reads["port"] == reads["jax"]
    _assert_same_trees(join(hw, "jax"), join(hw, "port"))
    assert len(_tree(join(hw, "port"))) == 6


def test_capture_setup_data_and_sync_test_match(hw):
    rng = np.random.default_rng(1)
    share = {sub: rng.random((2, 16, 16, 3)) for sub in ("train", "test")}
    for name, mod in PACKAGES:
        root = join(hw, name)
        for sub, ims in share.items():
            save_imgs(ims, join(root, "prj_share", sub))
        pc = mod.HardwareProCams(SETUP_INFO)
        mod.capture_setup_data(pc, root, "hwtest")
        cap = mod.sync_test(pc, root, "hwtest", count=3)
        assert cap == join(root, "setups/hwtest/cam/raw/numbers")
        pc.release()
    _assert_same_trees(join(hw, "jax"), join(hw, "port"))
    h, w = SETUP_INFO["cam_im_sz"][1], SETUP_INFO["cam_im_sz"][0]
    got = _tree(join(hw, "port", "setups/hwtest"))
    for sub, n in (("ref", 3), ("cb", 2), ("train", 2), ("test", 2),
                   ("numbers", 3)):
        keys = [k for k in got if k.startswith(f"cam/raw/{sub}/")]
        assert len(keys) == n and got[keys[0]].shape == (h, w, 3), sub


def test_main_hardware_steps_1_and_2(hw, monkeypatch):
    """``main --hardware --steps 1,2`` with the fakes: step 1 loads the
    setup's ``setup_info.yml``; step 2 runs the brightness / pose check,
    the sync test and the captures. The root ``main.py`` writes the same
    tree."""
    info = {k: list(v) if isinstance(v, tuple) else v
            for k, v in SETUP_INFO.items()}
    rng = np.random.default_rng(2)
    share = {sub: rng.random((2, 16, 16, 3)) for sub in ("train", "test")}
    roots = {name: join(hw, name, "data") for name, _ in PACKAGES}
    for root in roots.values():
        os.makedirs(join(root, "setups", "hwtest"))
        save_flat_yaml(info, join(root, "setups/hwtest/setup_info.yml"))
        for sub, ims in share.items():
            save_imgs(ims, join(root, "prj_share", sub))
    args = ["--hardware", "--setup-name", "hwtest", "--steps", "1,2",
            "--cam-index", "2"]
    TM.main(["--data-root", roots["port"], "--device", "cpu"] + args)
    assert FakeVideoCapture.instances[0].index == 2
    spec = importlib.util.spec_from_file_location("spaa_main",
                                                  join(REPO, "main.py"))
    root_main = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_main)
    monkeypatch.setattr(sys, "argv",
                        ["main.py", "--data-root", roots["jax"]] + args)
    root_main.main()
    _assert_same_trees(roots["jax"], roots["port"])
    assert len(os.listdir(join(roots["port"],
                               "setups/hwtest/cam/raw/train"))) == 2
    # no setup_info.yml: the hardware path stops before touching a device
    with pytest.raises(SystemExit, match="--steps 1"):
        TM.main(["--data-root", join(hw, "empty"), "--device", "cpu",
                 "--hardware", "--steps", "1"])


_PROBE = """
import sys
sys.modules["cv2"] = None
sys.modules["matplotlib"] = None
import spaa_tpu_torch.utils.procams as P
import spaa_tpu_torch.main
for name in ("init_prj_window", "init_cam", "_center_crop_np", "preview_cam",
             "HardwareProCams", "project_capture_data",
             "adjust_setup_brightness_and_pose", "sync_test",
             "capture_setup_data"):
    assert callable(getattr(P, name)), name
try:
    P.init_cam()
except ImportError:
    print("ok")
"""


def test_procams_imports_without_cv2_and_matplotlib():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
