"""Real ProCams hardware I/O (projector window, camera capture) and the
project-and-capture workflows on any ProCams object (counterpart of
``spaa_tpu/utils/procams.py``, reference ``utils.py:495-625``).

``procams`` is anything with ``setup_info`` and ``project_capture_data``:
the simulator ``utils.sim_procams.SimProCams`` or :class:`HardwareProCams`.
The hardware functions need OpenCV, matplotlib and a camera, which the GPU
machine lacks: ``cv2`` and ``matplotlib`` are imported inside them only,
so this module imports without either. Captures are written with
``cv2.imwrite`` (BGR), as in ``spaa_tpu``.
"""

from __future__ import annotations

import math
import os
import sys
import time
import warnings
from os.path import join

import numpy as np

from spaa_tpu_torch.utils.imgproc_host import (checkerboard,
                                               create_gray_pattern,
                                               create_number_pattern)
from spaa_tpu_torch.utils.io import imread_dir, make_setup_subdirs, save_imgs
from spaa_tpu_torch.utils.sim_procams import resize_nearest


def init_prj_window(prj_w: int, prj_h: int, val: float, offset=(3840, 0)):
    """Fullscreen matplotlib window on the projector display (ref
    ``utils.py:495-533``). Returns the image artist whose ``set_data``
    updates the projection."""
    import cv2 as cv
    import matplotlib
    import matplotlib.pyplot as plt
    matplotlib.rcParams["toolbar"] = "None"
    matplotlib.rcParams["figure.facecolor"] = "black"

    im = np.ones((prj_h, prj_w, 3), np.uint8) * int(val * 255)
    disp = min(prj_h, prj_w)
    im = cv.resize(im, (disp, disp))

    backend = plt.get_backend()
    fig = plt.figure()
    if "Qt" in backend:
        fig.canvas.window().statusBar().setVisible(False)
    ax = plt.imshow(im, interpolation="bilinear")
    plt.axis("off")
    plt.tight_layout()
    plt.subplots_adjust(left=0, right=1, top=1, bottom=0)
    mng = plt.get_current_fig_manager()
    if "Qt" in backend:
        mng.window.setGeometry(*offset, prj_w, prj_h)
        mng.full_screen_toggle()
    elif "Tk" in backend:
        mng.window.geometry(f"{prj_w}x{prj_h}+{offset[0]}+{offset[1]}")
        mng.window.overrideredirect(1)
        mng.window.state("zoomed")
        plt.pause(0.02)
    fig.show()
    return ax


def init_cam(cam_raw_sz=None, index: int = 0):
    """OpenCV camera with a one-frame buffer at 60 fps (ref
    ``utils.py:536-551``). ``index``: the VideoCapture device."""
    import cv2 as cv
    cam = cv.VideoCapture(index, cv.CAP_DSHOW) if sys.platform == "win32" \
        else cv.VideoCapture(index)
    if cam_raw_sz is not None:
        cam.set(cv.CAP_PROP_FRAME_WIDTH, cam_raw_sz[0])
        cam.set(cv.CAP_PROP_FRAME_HEIGHT, cam_raw_sz[1])
    cam.set(cv.CAP_PROP_BUFFERSIZE, 1)
    cam.set(cv.CAP_PROP_FPS, 60)
    time.sleep(2)
    if not cam.isOpened():
        print("Cannot open camera")
    return cam


def _center_crop_np(im: np.ndarray, size_wh) -> np.ndarray:
    """The centre ``(w, h)`` crop, clamped to the frame: a request larger
    than the frame gives the whole frame, not negative offsets."""
    h, w = im.shape[:2]
    tw, th = min(int(size_wh[0]), w), min(int(size_wh[1]), h)
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return im[i:i + th, j:j + tw]


def preview_cam(cam_raw_sz=None, cam_crop_sz=None, cam=None):
    """Live preview until 'q' (ref ``utils.py:554-575``). ``cam``: an open
    VideoCapture to reuse (single-consumer backends refuse a second open of
    the device); it is left open for the caller."""
    import cv2 as cv
    own = cam is None
    if own:
        cam = init_cam(cam_raw_sz)
    while True:
        ok, im_cam = cam.read()
        if not ok:
            print("Can't receive frame (stream end?). Exiting ...")
            break
        im = _center_crop_np(im_cam, cam_crop_sz) if cam_crop_sz else im_cam
        cv.imshow("Camera preview (press q to exit)", im)
        if cv.waitKey(1) == ord("q"):
            break
    if own:
        cam.release()
    cv.destroyAllWindows()


def _cam_image(im_cam: np.ndarray, info) -> np.ndarray:
    """A camera frame cropped to ``cam_crop_sz`` and area-resized to
    ``cam_im_sz`` (BGR uint8)."""
    import cv2 as cv
    return cv.resize(_center_crop_np(im_cam, info["cam_crop_sz"]),
                     tuple(info["cam_im_sz"]), interpolation=cv.INTER_AREA)


class HardwareProCams:
    """A projector window and a camera behind the simulator's interface
    (``capture``, ``project_capture_data``)."""

    def __init__(self, setup_info, cam_index: int = 0):
        self.setup_info = setup_info
        self.prj = init_prj_window(*setup_info["prj_screen_sz"],
                                   setup_info["prj_brightness"],
                                   setup_info["prj_offset"])
        self.cam = init_cam(setup_info["cam_raw_sz"], index=cam_index)

    def project(self, im_hwc: np.ndarray, delay_time: float = 0.3):
        import matplotlib.pyplot as plt
        im = im_hwc if im_hwc.dtype == np.uint8 \
            else (im_hwc * 255).astype(np.uint8)
        self.prj.set_data(im)
        plt.pause(delay_time)
        plt.draw()

    def capture(self, prj_im: np.ndarray | None = None) -> np.ndarray:
        """Project ``prj_im`` (if given), drop ``delay_frames`` stale frames
        and return the last one as HWC float32 RGB in [0, 1]."""
        import cv2 as cv
        info = self.setup_info
        if prj_im is not None:
            self.project(prj_im, info["delay_time"])
        for _ in range(info["delay_frames"]):
            _, im_cam = self.cam.read()
        im = _cam_image(im_cam, info)
        return cv.cvtColor(im, cv.COLOR_BGR2RGB).astype(np.float32) / 255.0

    def project_capture_data(self, prj_input_path: str, cam_cap_path: str,
                             setup_info=None) -> None:
        project_capture_data(prj_input_path, cam_cap_path,
                             setup_info or self.setup_info,
                             prj=self.prj, cam=self.cam)

    def release(self):
        import matplotlib.pyplot as plt
        self.cam.release()
        plt.close("all")


def project_capture_data(prj_input_path: str, cam_cap_path: str, setup_info,
                         prj=None, cam=None) -> None:
    """Batch project-and-capture with open-loop sync (ref
    ``utils.py:578-625``): per image, project, pause ``delay_time``, drop
    ``delay_frames`` stale frames, crop, resize and save. Without ``prj``
    it opens its own window and camera and clears the camera's buffer."""
    import cv2 as cv
    import matplotlib.pyplot as plt
    print(f"Projecting {prj_input_path} and \ncapturing to {cam_cap_path}")
    info = setup_info
    os.makedirs(cam_cap_path, exist_ok=True)

    im_prj = np.uint8(imread_dir(prj_input_path) * 255)
    prj_im_aspect = im_prj.shape[2] / im_prj.shape[1]
    prj_screen_aspect = info["prj_screen_sz"][0] / info["prj_screen_sz"][1]
    if not math.isclose(prj_im_aspect, prj_screen_aspect, abs_tol=1e-3):
        warnings.warn(
            f"projector input aspect {prj_im_aspect} differs from screen "
            f"aspect {prj_screen_aspect}; image will center-fill the screen")

    own = prj is None
    if own:
        plt.close("all")
        prj = init_prj_window(*info["prj_screen_sz"], 0.5, info["prj_offset"])
        cam = init_cam(info["cam_raw_sz"])
        for _ in range(100):  # clear the camera's buffer
            cam.read()

    for i in range(im_prj.shape[0]):
        prj.set_data(im_prj[i])
        plt.pause(info["delay_time"])
        plt.draw()
        for _ in range(info["delay_frames"]):
            _, im_cam = cam.read()
        cv.imwrite(join(cam_cap_path, f"img_{i + 1:04d}.png"),
                   _cam_image(im_cam, info))

    if own:
        cam.release()
        plt.close("all")


def adjust_setup_brightness_and_pose(procams) -> None:
    """Interactive pre-capture check (ref ``main.py:41-50``): black, setup
    gray and white fullscreen windows to adjust the projector's brightness
    and focus and the object's pose, with a live camera preview ('q'
    ends). Takes the live :class:`HardwareProCams`, whose open camera is
    reused; only the windows opened here are closed, so the ProCams
    projector window stays."""
    import matplotlib.pyplot as plt
    setup_info = procams.setup_info
    existing_figs = set(plt.get_fignums())
    for brightness in [0.0, float(setup_info["prj_brightness"]), 1.0]:
        init_prj_window(*setup_info["prj_screen_sz"], brightness,
                        setup_info["prj_offset"])
    # ref main.py:50 previews an (800, 600) crop, clamped to the frame
    preview_cam(setup_info["cam_raw_sz"], (800, 600),
                cam=getattr(procams, "cam", None))
    for num in set(plt.get_fignums()) - existing_figs:
        plt.close(num)


def sync_test(procams, data_root: str, setup_name: str = "sync_test",
              count: int = 10) -> str:
    """Projector/camera sync check (ref ``main.py:52-61``): project the
    numbered patterns of ``prj_share/numbers`` (generated if absent) and
    capture them to ``setups/<setup_name>/cam/raw/numbers``; each captured
    frame must show its projected number. Returns the capture directory."""
    info = procams.setup_info
    prj_input_path = join(data_root, "prj_share", "numbers")
    if not os.path.isdir(prj_input_path) or not os.listdir(prj_input_path):
        pw, ph = info["prj_im_sz"]
        save_imgs(create_number_pattern(pw, ph, count), prj_input_path)
        print(f"[sync_test] generated {count} number patterns in "
              f"{prj_input_path}")
    cam_cap_path = join(data_root, "setups", setup_name, "cam/raw/numbers")
    procams.project_capture_data(prj_input_path, cam_cap_path, info)
    print(f"[sync_test] inspect {cam_cap_path}: each captured frame must "
          "show the same number as its projected input - otherwise "
          "increase delay_time/delay_frames in setup_info")
    return cam_cap_path


def capture_setup_data(procams, data_root: str, setup_name: str) -> None:
    """Project and capture everything a setup needs (reference ``main.py``
    cells 2-3): black / gray / white references, the two complementary
    checkerboards, Gray-code structured light, and the shared
    ``prj_share`` train and test patterns. ``procams``: HardwareProCams or
    SimProCams."""
    setup_path = join(data_root, "setups", setup_name)
    make_setup_subdirs(setup_path)
    info = procams.setup_info
    pw, ph = info["prj_im_sz"]

    ref = np.stack([np.zeros((ph, pw, 3), np.float32),
                    np.full((ph, pw, 3), float(info["prj_brightness"]),
                            np.float32),
                    np.ones((ph, pw, 3), np.float32)])
    save_imgs(ref, join(setup_path, "prj/raw/ref"))

    # ref main.py:116-120: 32 squares per half image, binarised
    num_squares = 32
    cb_sz = max(ph // (num_squares * 2), 1)
    cb = checkerboard(cb_sz, num_squares)
    cb1 = (cb > 0.5).astype(np.float32)
    cb2 = (cb < 0.5).astype(np.float32)
    if cb1.shape != (ph, pw):
        cb1 = resize_nearest(cb1, (pw, ph))
        cb2 = resize_nearest(cb2, (pw, ph))
    save_imgs(np.stack([np.repeat(cb1[..., None], 3, -1),
                        np.repeat(cb2[..., None], 3, -1)]),
              join(setup_path, "prj/raw/cb"))

    gray = create_gray_pattern(pw, ph).astype(np.float32) / 255.0
    save_imgs(gray, join(setup_path, "prj/raw/sl"))

    pairs = [("prj/raw/ref", "cam/raw/ref"),
             ("prj/raw/cb", "cam/raw/cb"),
             ("prj/raw/sl", "cam/raw/sl"),
             (join(data_root, "prj_share/train"), "cam/raw/train"),
             (join(data_root, "prj_share/test"), "cam/raw/test")]
    for src, dst in pairs:
        src_path = src if os.path.isabs(src) or src.startswith(data_root) \
            else join(setup_path, src)
        if not os.path.isdir(src_path):
            print(f"[capture_setup_data] skipping missing {src_path}")
            continue
        procams.project_capture_data(src_path, join(setup_path, dst), info)
