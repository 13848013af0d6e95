"""Port parity: ``threshold_im`` without OpenCV.

On the direct-light images of two sim setups and on synthetic masks with
several components, holes and pixels on the image border, the mask and
the corners equal ``spaa_tpu``'s (cv2 ``findContours`` /
``boundingRect``) exactly. The ROI (cv2 ``convexHull`` +
``fillConvexPoly``) may differ only on the hull's edge; the count of such
pixels is asserted, and it is 0 on every input here.
"""

import numpy as np
import pytest

from spaa_tpu.utils.imgproc_host import threshold_im as jax_threshold_im
from spaa_tpu.utils.sim_procams import DEFAULT_SIM_SETUP_INFO, SimProCams
from spaa_tpu_torch.train.data import nayar_separation
from spaa_tpu_torch.utils.imgproc_host import threshold_im

EDGE_PIXELS_ALLOWED = 0


def _edge(roi):
    """Pixels of ``roi`` with an 8-neighbour on the other side."""
    p = np.pad(roi, 1, mode="edge")
    h, w = roi.shape
    nb = [p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
          for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return np.any([n != roi for n in nb], axis=0)


def _compare(im):
    m_j, roi_j, c_j = jax_threshold_im(im)
    m_t, roi_t, c_t = threshold_im(im)
    np.testing.assert_array_equal(m_t, m_j)
    assert c_t == c_j
    differ = roi_t != roi_j
    assert not (differ & ~(_edge(roi_j) | _edge(roi_t))).any(), \
        "ROI differs away from the hull's edge"
    assert differ.sum() <= EDGE_PIXELS_ALLOWED, int(differ.sum())
    return m_t, roi_t


@pytest.mark.parametrize("size", [None, ([64, 64], [64, 48])])
def test_sim_direct_images(size):
    info = dict(DEFAULT_SIM_SETUP_INFO)
    if size:
        info.update(prj_im_sz=size[0], cam_im_sz=size[1])
    sim = SimProCams(info, seed=7)
    cb = (np.indices(sim.prj_hw).sum(0) // 4 % 2).astype(np.float32)
    caps = sim.capture_batch(np.stack([np.repeat(cb[..., None], 3, -1),
                                       np.repeat(1 - cb[..., None], 3, -1)]))
    caps = np.uint8(np.clip(caps, 0, 1) * 255) / np.float32(255)
    mask, roi = _compare(nayar_separation(caps)[0])
    assert 0.2 < mask.mean() < 0.9 and (roi >= mask).all()


def _synthetic_masks():
    rng = np.random.default_rng(0)
    for _ in range(24):
        h, w = rng.integers(20, 110, 2)
        yy, xx = np.mgrid[:h, :w]
        m = np.zeros((h, w), bool)
        for _ in range(rng.integers(2, 5)):          # several components
            cy, cx = rng.integers(0, h), rng.integers(0, w)   # may cross
            ry, rx = rng.integers(2, h // 3 + 3), rng.integers(2, w // 3 + 3)
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            hole = ((yy - cy) / max(ry / 3, 1)) ** 2 \
                + ((xx - cx) / max(rx / 3, 1)) ** 2 <= 1
            m |= blob & ~hole
        yield m
    for _ in range(6):                               # scattered pixels
        h, w = rng.integers(10, 60, 2)
        m = rng.random((h, w)) < 0.05
        m[rng.integers(0, h), rng.integers(0, w)] = True
        yield m
    line = np.zeros((9, 13), bool)                   # degenerate hulls
    line[4, 2:11] = True
    yield line
    dot = np.zeros((5, 5), bool)
    dot[0, 4] = True
    yield dot


def test_synthetic_masks():
    n = 0
    for m in _synthetic_masks():
        mask, roi = _compare(m)
        assert (mask == m).all() and (roi >= m).all()
        n += 1
    assert n == 32


def test_compensation_and_empty_mask_raise():
    # the compensation branch is ported (test_torch_port_compennet.py
    # holds it against spaa_tpu); an empty mask raises in either branch
    for compensation in (False, True):
        with pytest.raises(ValueError, match="no foreground pixel"):
            threshold_im(np.zeros((8, 8), bool), compensation=compensation)
