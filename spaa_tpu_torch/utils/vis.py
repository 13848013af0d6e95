"""Optional visualisation (counterpart of ``spaa_tpu/utils/vis.py``).

Training curves go to a JSONL file, so a headless run keeps its curves
without a display server. The visdom plots (:func:`init_visdom`,
:func:`vfs`, :func:`append_data_point`, :func:`plot_montage`) and the
matplotlib figure (:func:`fs`) import their package only when called, and
do nothing without it or without a server: the reference instead asserts
a running visdom server at import (``utils.py:53-67``).
:func:`vis_pcnet_process` builds its montage headless and returns it.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from spaa_tpu_torch.utils.imgproc_host import (make_grid,
                                               make_grid_transposed,
                                               resize_linear_np)

_vis = None


def init_visdom(server: str = "localhost", port: int = 8097):
    """Connect to a visdom server if the package is installed and the
    server answers; else return None and leave plotting off."""
    global _vis
    try:
        import visdom
    except ImportError:
        visdom = None
    if visdom is not None:
        v = visdom.Visdom(server=server, port=port, use_incoming_socket=False)
        if v.check_connection():
            _vis = v
            return v
    print("[vis] visdom unavailable - plotting disabled")
    return None


class CurveLogger:
    """Appends ``{"step", "t", <scalars>}`` records to a JSONL file, and
    each scalar as a point of the visdom window ``curves`` when a server
    is connected."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def append(self, step: int, **scalars) -> None:
        if self._f:
            rec = {"step": int(step), "t": time.time()}
            rec.update({k: float(v) for k, v in scalars.items()})
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if _vis is not None:
            for k, v in scalars.items():
                append_data_point(step, float(v), win="curves", name=k)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def vfs(x, padding: int = 10, title: Optional[str] = None,
        ncol: Optional[int] = None):
    """visdom figure show of HWC or NHWC images (ref ``utils.py:213-223``);
    nothing when offline."""
    if _vis is None:
        return None
    t = title or ""
    x = np.asarray(x)
    if x.ndim == 3:
        return _vis.image(x.transpose(2, 0, 1), opts=dict(title=t, caption=t))
    if x.ndim == 4 and x.shape[0] == 1:
        return _vis.image(x[0].transpose(2, 0, 1),
                          opts=dict(title=t, caption=t))
    return _vis.images(x.transpose(0, 3, 1, 2),
                       opts=dict(title=t, caption=t),
                       nrow=ncol or 5, padding=padding)


def append_data_point(x, y, win, name, env=None):
    """One point appended to a visdom line plot (ref ``utils.py:226-236``);
    nothing when offline."""
    if _vis is None:
        return
    _vis.line(X=np.array([x]), Y=np.array([y]), env=env, win=win,
              update="append", name=name,
              opts=dict(markers=True, markersize=3))


def plot_montage(*image_batches, index=None, win=None, title=None, env=None,
                 grid_w: int = 5, cp_sz=None):
    """Montage of the same samples of several NHWC batches, each tile
    centre-cropped to ``cp_sz`` and resized to 256x256 (ref
    ``utils.py:259-298``); nothing when offline."""
    if _vis is None:
        return None
    n = image_batches[0].shape[0]
    gw = min(grid_w, n)
    idx = index if index is not None else (
        random.sample(range(n), gw) if n > gw else list(range(gw)))
    tiles = []
    for batch in image_batches:
        for i in idx:
            im = np.asarray(batch[i])
            if cp_sz is not None:
                h, w = im.shape[:2]
                ti, tj = (h - cp_sz[0]) // 2, (w - cp_sz[1]) // 2
                im = im[ti:ti + cp_sz[0], tj:tj + cp_sz[1]]
            tiles.append(resize_linear_np(im, (256, 256)))
    grid = make_grid(np.stack(tiles, 0), nrow=gw, padding=10, pad_value=1.0)
    return _vis.image(grid.transpose(2, 0, 1), win=win,
                      opts=dict(title=title, caption=title), env=env)


def vis_pcnet_process(pcnet, prj_input, cam_scene, cam_train, cam_mask,
                      mask=None, title="PCNet process "
                      "(intermediate results)"):
    """PCNet's intermediate stages as one montage (ref
    ``vis_pcnet_process``, ``utils.py:239-256``): scene, mask, projector
    input, warped input, masked warp, rough render, inferred capture and
    the captured one, two per column. Returns the montage (HWC float)
    and shows it in visdom when a server is connected.

    ``pcnet``: a :class:`~spaa_tpu_torch.models.pcnet.PCNet`; prj_input
    [1, Hp, Wp, 3]; cam_scene and cam_train [1, H, W, 3]; cam_mask
    [H, W, 1], all NHWC tensors on the model's device or numpy arrays."""
    p = next(pcnet.parameters())

    def t(a):
        return torch.as_tensor(a).to(p.device, p.dtype)

    def host(a):
        return a.detach().cpu().numpy()

    m = t(cam_mask if mask is None else mask)
    prj, scene = t(prj_input), t(cam_scene)
    with torch.no_grad():
        prj_warp = host(pcnet.warping_net(prj))
        cam_infer = host(pcnet(prj, scene, m))
    m, scene, prj = host(m), host(scene), host(prj)
    prj_warp_masked = prj_warp * m
    cam_rough = prj_warp_masked * scene

    h, w = scene.shape[1:3]
    mask_vis = np.repeat(np.asarray(m, np.float32).reshape(h, w, 1), 3, -1)
    panels = [scene[0], mask_vis, resize_linear_np(prj[0], (w, h)),
              prj_warp[0], prj_warp_masked[0], cam_rough[0], cam_infer[0],
              host(t(cam_train))[0]]
    montage = make_grid_transposed(np.stack(panels, 0), nrow=2, padding=5,
                                   pad_value=1.0)
    vfs(montage, title=title)
    return montage


def fs(input_data, title=None, cmap="gray", facecolor="black"):
    """Figure show through matplotlib (ref ``utils.py:171-210``); nothing
    without matplotlib."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    im = np.squeeze(np.asarray(input_data))
    fig = plt.figure(facecolor=facecolor)
    plt.imshow(im, interpolation="bilinear", cmap=cmap)
    plt.axis("off")
    plt.tight_layout(pad=0)
    if title is not None:
        plt.title(title, color="red")
    plt.show()
    return fig
