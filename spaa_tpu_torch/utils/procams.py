"""Project-and-capture workflows on any ProCams object (counterpart of
``spaa_tpu/utils/procams.py:219-300``).

``procams`` is anything with ``setup_info`` and ``project_capture_data``:
here the simulator, ``utils.sim_procams.SimProCams``. ``spaa_tpu``'s
real-ProCams code (``HardwareProCams``: projector window, camera capture
and the interactive helpers, ``spaa_tpu/utils/procams.py:25-216``) needs
OpenCV and a camera, which the GPU machine lacks; it is not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np

from spaa_tpu_torch.utils.imgproc_host import (checkerboard,
                                               create_gray_pattern,
                                               create_number_pattern)
from spaa_tpu_torch.utils.io import make_setup_subdirs, save_imgs
from spaa_tpu_torch.utils.sim_procams import resize_nearest


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
    ``prj_share`` train and test patterns."""
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
