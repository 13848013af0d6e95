"""Synthetic ProCams without OpenCV (counterpart of
``spaa_tpu/utils/sim_procams.py``).

An analytic project-and-capture simulator: cam = clip(ambient + albedo *
(0.15 + 0.85 * mix(warp(prj)))), with a smooth random albedo, a fixed
affine projector-to-camera warp and channel crosstalk. ``make_setup`` writes
a complete setup tree (``cam/raw/{ref,cb,train,test}``, ``prj/raw/{ref,cb}``,
``prj_share/{train,test,init}``, ``setup_info.yml``) so training and the
attack run without captured data.

The four OpenCV calls of ``spaa_tpu``'s simulator are reproduced in numpy:
``resize`` (bicubic, a = -0.75, half-pixel source mapping, replicated
border; nearest, ``floor(dst * scale)``), ``getAffineTransform`` (a 6x6
solve in float64) and ``warpAffine`` (bilinear, zero border). OpenCV 5's
``warpAffine`` maps float32 source coordinates without the 1/32-pixel
tables of OpenCV 4, and so does :class:`AffineWarp`; the two agree
to a few float32 ulps (far below one uint8 count) and give the same
``> 0.5`` footprint.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from spaa_tpu_torch.utils.config import DictConfig, save_flat_yaml
from spaa_tpu_torch.utils.imgproc_host import checkerboard
from spaa_tpu_torch.utils.io import imread_dir, save_imgs

DEFAULT_SIM_SETUP_INFO = dict(
    prj_screen_sz=[800, 600],
    prj_im_sz=[256, 256],
    prj_offset=[3840, 0],
    cam_raw_sz=[1280, 720],
    cam_crop_sz=[960, 720],
    cam_im_sz=[320, 240],          # (w, h) like the reference
    classifier_crop_sz=[240, 240],
    prj_brightness=0.5,
    delay_frames=13,
    delay_time=0.02,
)


def _cubic_taps(n_in: int, n_out: int):
    """Source indices [n_out, 4] (replicated border) and float32 weights of
    cv2's bicubic resize along one axis."""
    scale = n_in / n_out
    f = np.float32
    fx = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(f)
    sx = np.floor(fx)
    x = fx - sx
    a, one = f(-0.75), f(1)
    c0 = ((a * (x + one) - f(5) * a) * (x + one) + f(8) * a) * (x + one) \
        - f(4) * a
    c1 = ((a + f(2)) * x - (a + f(3))) * x * x + one
    c2 = ((a + f(2)) * (one - x) - (a + f(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(f)


def resize_cubic(src: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(src, dsize=(w, h), interpolation=INTER_CUBIC) of an
    HxW[xC] float32 image: rows first, then columns, in float32."""
    w, h = int(dsize[0]), int(dsize[1])
    s = np.asarray(src, np.float32)
    if s.shape[:2] == (h, w):
        return s.copy()
    xi, xw = _cubic_taps(s.shape[1], w)
    yi, yw = _cubic_taps(s.shape[0], h)
    tail = (None,) * (s.ndim - 2)
    t = s[:, xi[:, 0]] * xw[(None, slice(None), 0) + tail]
    for k in range(1, 4):
        t = t + s[:, xi[:, k]] * xw[(None, slice(None), k) + tail]
    out = t[yi[:, 0]] * yw[(slice(None), 0, None) + tail]
    for k in range(1, 4):
        out = out + t[yi[:, k]] * yw[(slice(None), k, None) + tail]
    return out


def resize_nearest(src: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(..., INTER_NEAREST): source index ``floor(dst * scale)``
    with no half-pixel offset, clamped to the last pixel."""
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = src.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (sh / h)).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (sw / w)).astype(np.int64), sw - 1)
    return src[ys[:, None], xs[None, :]]


def get_affine_transform(src, dst) -> np.ndarray:
    """cv2.getAffineTransform: the 2x3 float64 affine mapping three source
    points onto three destination points."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((6, 6))
    for i in range(3):
        a[2 * i, :3] = [src[i, 0], src[i, 1], 1.0]
        a[2 * i + 1, 3:] = [src[i, 0], src[i, 1], 1.0]
    return np.linalg.solve(a, dst.reshape(6)).reshape(2, 3)


class AffineWarp:
    """cv2.warpAffine(src, m, dsize=(w, h)) with INTER_LINEAR and a zero
    border, for any number of same-size images: the inverse map and the
    four taps are computed once."""

    def __init__(self, m: np.ndarray, src_hw, dsize):
        w, h = int(dsize[0]), int(dsize[1])
        sh, sw = int(src_hw[0]), int(src_hw[1])
        m = np.asarray(m, np.float64).ravel()
        d = m[0] * m[4] - m[1] * m[3]
        d = 1.0 / d if d != 0 else 0.0
        inv = np.array([m[4] * d, -m[1] * d, 0.0, -m[3] * d, m[0] * d, 0.0])
        inv[2] = -inv[0] * m[2] - inv[1] * m[5]
        inv[5] = -inv[3] * m[2] - inv[4] * m[5]
        f = np.float32
        inv = inv.astype(f)
        xs = np.arange(w, dtype=f)[None]
        ys = np.arange(h, dtype=f)[:, None]
        sx_f = (inv[0] * xs + inv[1] * ys) + inv[2]
        sy_f = (inv[3] * xs + inv[4] * ys) + inv[5]
        x0, y0 = np.floor(sx_f), np.floor(sy_f)
        fx, fy = sx_f - x0, sy_f - y0
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        one = f(1)
        self.shape = (h, w)
        self.taps = []
        for dy, wy in ((0, one - fy), (1, fy)):
            for dx, wx in ((0, one - fx), (1, fx)):
                xx, yy = x0 + dx, y0 + dy
                ok = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
                flat = (np.clip(yy, 0, sh - 1) * sw + np.clip(xx, 0, sw - 1))
                self.taps.append((flat.ravel(), ok.ravel(),
                                  (wx * wy).astype(f).ravel()))

    def __call__(self, src: np.ndarray) -> np.ndarray:
        s = np.asarray(src, np.float32)
        tail = s.shape[2:]
        flat = s.reshape((-1,) + tail)
        out = None
        for idx, ok, wgt in self.taps:
            v = np.where(ok.reshape((-1,) + (1,) * len(tail)), flat[idx],
                         np.float32(0))
            t = v * wgt.reshape((-1,) + (1,) * len(tail))
            out = t if out is None else out + t
        return out.reshape(self.shape + tail)


class SimProCams:
    """Analytic project-and-capture simulator."""

    def __init__(self, setup_info: Optional[dict] = None, seed: int = 7):
        self.setup_info = DictConfig(setup_info or DEFAULT_SIM_SETUP_INFO)
        rng = np.random.default_rng(seed)
        w, h = self.setup_info["cam_im_sz"]          # (w, h)
        pw, ph = self.setup_info["prj_im_sz"]
        self.cam_hw = (h, w)
        self.prj_hw = (ph, pw)

        # scene albedo: smooth random blobs (the "object")
        base = rng.random((h // 8, w // 8, 3)).astype(np.float32)
        self.albedo = resize_cubic(base, (w, h))
        self.albedo = np.clip(self.albedo * 0.7 + 0.25, 0, 1)

        # ambient light + projector gain with slight channel crosstalk
        self.ambient = 0.08 + 0.04 * rng.random(3).astype(np.float32)
        mix = np.eye(3, dtype=np.float32) * 0.85 + 0.05
        self.mix = mix / mix.sum(1, keepdims=True) * 0.9

        # ground-truth affine prj->cam (the projection lands in a sub-region)
        mrg_x, mrg_y = int(0.15 * w), int(0.12 * h)
        self.dst_quad = np.float32([[mrg_x, mrg_y], [w - mrg_x, mrg_y],
                                    [w - mrg_x, h - mrg_y]])
        src_quad = np.float32([[0, 0], [pw - 1, 0], [pw - 1, ph - 1]])
        self.warp_mat = get_affine_transform(src_quad, self.dst_quad)
        self._warp = AffineWarp(self.warp_mat, (ph, pw), (w, h))

        # direct-light region = warped full-white footprint
        self.footprint = self._warp(np.ones((ph, pw), np.float32)) > 0.5

    def capture(self, prj_im: np.ndarray) -> np.ndarray:
        """Simulate one capture. prj_im: HWC float [0,1] at prj size.
        Returns HWC float [0,1] at cam size."""
        warped = self._warp(prj_im)
        lit = warped @ self.mix.T
        cam = self.ambient + self.albedo * (0.15 + 0.85 * lit)
        cam = np.where(self.footprint[..., None],
                       cam, self.ambient + self.albedo * 0.15)
        return np.clip(cam, 0, 1).astype(np.float32)

    def capture_batch(self, prj_ims: np.ndarray) -> np.ndarray:
        return np.stack([self.capture(p) for p in prj_ims], 0)

    def make_setup(self, data_root: str, setup_name: str,
                   num_train: int = 24, num_test: int = 8,
                   seed: int = 11) -> str:
        """Write a full synthetic setup tree + shared projector images
        (the capture workflow of ``main.py`` cells 1-4)."""
        setup_path = os.path.join(data_root, "setups", setup_name)
        ph, pw = self.prj_hw
        bright = float(self.setup_info["prj_brightness"])

        # shared projector train/test images (smooth colored noise)
        def _prj_batch(n, key):
            r = np.random.default_rng(key)
            base = r.random((n, max(ph // 16, 2), max(pw // 16, 2), 3))
            return np.stack([np.clip(resize_cubic(b.astype(np.float32),
                                                  (pw, ph)), 0, 1)
                             for b in base], 0)

        prj_train = _prj_batch(num_train, seed)
        prj_test = _prj_batch(num_test, seed + 1)
        save_imgs(prj_train, os.path.join(data_root, "prj_share/train"))
        save_imgs(prj_test, os.path.join(data_root, "prj_share/test"))
        save_imgs(prj_train[: max(num_train // 2, 2)],
                  os.path.join(data_root, "prj_share/init"))

        # ref: black / gray / white projections
        refs = np.stack([np.full((ph, pw, 3), v, np.float32)
                         for v in (0.0, bright, 1.0)], 0)
        save_imgs(refs, os.path.join(setup_path, "prj/raw/ref"))
        save_imgs(self.capture_batch(refs),
                  os.path.join(setup_path, "cam/raw/ref"))

        # cb: two complementary checkerboards (ref main.py:116-120)
        num_squares = 32
        cb_sz = max(pw // (num_squares * 2), 1)
        cb0 = (checkerboard(cb_sz, num_squares) > 0.5).astype(np.float32)
        cb0 = resize_nearest(cb0, (pw, ph))
        cbs = np.stack([np.tile(cb0[..., None], (1, 1, 3)),
                        np.tile(1 - cb0[..., None], (1, 1, 3))], 0)
        save_imgs(cbs, os.path.join(setup_path, "prj/raw/cb"))
        save_imgs(self.capture_batch(cbs),
                  os.path.join(setup_path, "cam/raw/cb"))

        # train/test captures
        save_imgs(self.capture_batch(prj_train),
                  os.path.join(setup_path, "cam/raw/train"))
        save_imgs(self.capture_batch(prj_test),
                  os.path.join(setup_path, "cam/raw/test"))

        save_flat_yaml(self.setup_info,
                       os.path.join(setup_path, "setup_info.yml"))
        return setup_path

    def project_capture_data(self, prj_input_path: str, cam_cap_path: str,
                             setup_info=None) -> None:
        """Drop-in for the hardware ``project_capture_data``
        (ref ``utils.py:578-625``) backed by the simulator."""
        prj = imread_dir(prj_input_path)
        os.makedirs(cam_cap_path, exist_ok=True)
        save_imgs(self.capture_batch(prj), cam_cap_path)
