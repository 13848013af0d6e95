"""Host-side image processing without OpenCV (counterpart of
``spaa_tpu/utils/imgproc_host.py:22-141``).

  - ``threshold_im``: direct-light mask (gray, uint8, 3x3 Gaussian, 2-class
    multi-Otsu), its ROI (the filled convex hull of the foreground) and the
    bounding-box corners in [-1, 1] grid coordinates (ref
    ``img_proc.py:13-65``). The mask half reproduces cv2's uint8
    ``GaussianBlur`` in 8-bit fixed point, so it is bit-exact; the ROI
    follows cv2's ``fillConvexPoly`` (LINE_8 outline, fixed-point scan).
  - ``checkerboard``: the MATLAB-style calibration pattern.
"""

from __future__ import annotations

import numpy as np

# cv2.getGaussianKernel(3, 1.5) in OpenCV's 8-bit fixed point (weights
# scaled by 256 and rounded; they sum to 256): the bit-exact path
# cv2.GaussianBlur takes for uint8 images
_GAUSS3_Q8 = np.array([79, 98, 79], np.int64)
_XY_SHIFT = 16      # cv2 drawing's fixed-point fraction bits


def multi_otsu(image_u8: np.ndarray, classes: int = 2) -> np.ndarray:
    """Multi-Otsu thresholds of a uint8 image (classes-1 thresholds),
    maximising the between-class variance by dynamic programming over
    segment scores S[a, b] = m(a,b)^2 / w(a,b) of the 256-bin histogram."""
    hist = np.bincount(image_u8.ravel(), minlength=256).astype(np.float64)
    p = hist / hist.sum()
    lv = np.arange(256, dtype=np.float64)
    cum_p = np.concatenate([[0.0], np.cumsum(p)])
    cum_m = np.concatenate([[0.0], np.cumsum(p * lv)])
    a_idx = np.arange(256)[:, None]
    b_idx = np.arange(256)[None, :]
    w = cum_p[b_idx + 1] - cum_p[a_idx]
    m = cum_m[b_idx + 1] - cum_m[a_idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where((w > 0) & (b_idx >= a_idx), m * m / np.maximum(w, 1e-300),
                     -np.inf)
    best = s[0, :].copy()
    args = []
    th_idx = np.arange(255)[:, None]
    t_idx = np.arange(256)[None, :]
    for _ in range(classes - 1):
        cand = np.where(th_idx < t_idx, best[:-1, None] + s[1:, :], -np.inf)
        arg = np.argmax(cand, axis=0)
        best = cand[arg, np.arange(256)]
        args.append(arg)
    ths = []
    t = 255
    for arg in reversed(args):
        t = int(arg[t])
        ths.append(t)
    return np.array(sorted(ths))


def _rgb2gray_u8(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(float32 RGB, RGB2GRAY) then np.uint8(x * 255)."""
    im = np.clip(im, 0, 1).astype(np.float32)
    gray = (im[..., 0] * np.float32(0.299) + im[..., 1] * np.float32(0.587)
            + im[..., 2] * np.float32(0.114))
    return np.uint8(gray * 255)


def _gaussian_blur3_u8(im_u8: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(im, (3, 3), 1.5) on uint8: separable 8-bit
    fixed-point weights, reflect-101 border, round half up."""
    k = _GAUSS3_Q8
    p = np.pad(im_u8.astype(np.int64), 1, mode="reflect")
    r = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
    c = k[0] * r[:-2] + k[1] * r[1:-1] + k[2] * r[2:]
    return ((c + (1 << 15)) >> 16).astype(np.uint8)


def direct_light_mask(im_direct: np.ndarray) -> np.ndarray:
    """Binary direct-light mask [H, W] bool of an HxWx3 float image: gray,
    uint8, 3x3 Gaussian (sigma 1.5), 2-class multi-Otsu, digitize."""
    smooth = _gaussian_blur3_u8(_rgb2gray_u8(im_direct))
    ths = multi_otsu(smooth, classes=2)
    return np.digitize(smooth, bins=ths) > 0


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Vertices of the convex hull of integer points [N, 2] (x, y), without
    collinear points (Andrew's monotone chain), exact in integers."""
    pts = np.unique(pts, axis=0)            # sorted by x, then y
    if len(pts) <= 2:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts.tolist():
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts.tolist()):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1], np.int64)


def _draw_line8(img: np.ndarray, p0, p1) -> None:
    """cv2's 8-connected Bresenham line (``LineIterator``, left to right)."""
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = x1 - x0, y1 - y0
    if dx < 0:                       # leftToRight: start at the left end
        dx, dy = -dx, -dy
        x0, y0 = x1, y1
    step_x, step_y = 1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    h, w = img.shape
    for _ in range(dx + 1):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = 1
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += step_y
            x += step_x if minor else 0
        else:
            x += step_x
            y += step_y if minor else 0


def _c_div(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fill_convex_poly(shape, v: np.ndarray) -> np.ndarray:
    """cv2.fillConvexPoly(zeros(shape, uint8), v, 1) with its defaults
    (LINE_8, shift 0): the polygon outline drawn 8-connected, then each
    scanline between the two tracked edges, in 16-bit fixed point."""
    img = np.zeros(shape, np.uint8)
    v = [(int(x), int(y)) for x, y in v]
    npts = len(v)
    p0 = v[-1]
    for p in v:
        _draw_line8(img, p0, p)
        p0 = p
    if npts < 3:
        return img
    h, w = shape
    ys = [p[1] for p in v]
    ymin, ymax = min(ys), min(max(ys), h - 1)
    imin = ys.index(ymin)
    one = 1 << _XY_SHIFT
    half = one >> 1
    edges = npts
    edge = [dict(idx=imin, di=1, x=-one, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-one, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = v[idx][1]
                    if ty > y:
                        xs, xe = v[idx0][0] << _XY_SHIFT, v[idx][0] << _XY_SHIFT
                        e.update(ye=ty, x=xs, idx=idx, dx=_c_div(
                            (xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted(edge, key=lambda e: e["x"])
            xx1 = (left["x"] + half) >> _XY_SHIFT
            xx2 = (right["x"] + half) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = 1
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break
    return img


def threshold_im(im_in: np.ndarray, compensation: bool = False):
    """Direct-light binary mask, ROI and bounding-box corners.

    im_in: HxWx3 float in [0, 1], or an HxW bool mask. Returns
    (im_mask [H, W] bool, im_roi [H, W] bool, corners: 4 [x, y] in [-1, 1]
    grid coordinates). The corners are the bounding box of every contour
    point, i.e. of the foreground, with cv2 ``boundingRect``'s inclusive
    width: ``x + w`` is one past the last foreground column."""
    if compensation:
        raise NotImplementedError(
            "threshold_im(compensation=True) serves CompenNet++ only and is "
            "not ported yet (ROADMAP.md queue A item 5: PerC-AL)")
    if im_in.ndim == 3:
        im_mask = direct_light_mask(im_in)
    elif im_in.dtype == bool:
        im_mask = im_in
    else:
        raise ValueError("expected HxWx3 float or HxW bool")
    rows = np.flatnonzero(im_mask.any(axis=1))
    if rows.size == 0:
        raise ValueError("threshold_im: the mask has no foreground pixel")
    cols = np.flatnonzero(im_mask.any(axis=0))
    # each foreground row's two extreme pixels span the same hull as all
    # foreground (and contour) pixels
    first = im_mask[rows].argmax(axis=1)
    last = im_mask.shape[1] - 1 - im_mask[rows, ::-1].argmax(axis=1)
    pts = np.concatenate([np.stack([first, rows], 1),
                          np.stack([last, rows], 1)])
    im_roi = _fill_convex_poly(im_mask.shape, _convex_hull(pts)) > 0

    x, y = int(cols[0]), int(rows[0])
    x2, y2 = int(cols[-1]) + 1, int(rows[-1]) + 1
    ih, iw = im_mask.shape
    corners = [[x, y], [x2, y], [x2, y2], [x, y2]]
    corners = [[2 * (cx / iw) - 1, 2 * (cy / ih) - 1] for cx, cy in corners]
    return im_mask, im_roi, corners


def checkerboard(*args) -> np.ndarray:
    """MATLAB-style checkerboard (ref ``img_proc.py:68-106``): left half
    0/1 tiles, right half 0/0.7 tiles."""
    n, p = 10, 4
    if len(args) == 1:
        n = args[0]
        q = p
    elif len(args) == 2:
        n, p = args
        q = p
    elif len(args) == 3:
        n, p, q = args
    else:
        q = p

    tile = np.kron([[0, 1], [1, 0]], np.ones((n, n)))
    if q % 2 == 0:
        reps = int(np.ceil(q / 2))
        left = np.tile(tile, (p, reps))
        tile_r = np.kron([[0, 0.7], [0.7, 0]], np.ones((n, n)))
        right = np.tile(tile_r, (p, reps))
        out = np.concatenate([left, right], axis=1)
    else:
        out = np.tile(tile, (p, q))
        mid = out.shape[1] // 2 + 1
        out[:, mid:] = np.maximum(out[:, mid:] - 0.3, 0)
    return out.astype(np.float64)
