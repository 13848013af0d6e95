"""Host-side image processing without OpenCV or Pillow (counterpart of
``spaa_tpu/utils/imgproc_host.py``).

  - ``threshold_im``: direct-light mask (gray, uint8, 3x3 Gaussian, 2-class
    multi-Otsu; 4-class for CompenNet++), its ROI (the filled convex hull
    of the foreground, or of its largest contour for CompenNet++) and the
    bounding-box corners in [-1, 1] grid coordinates (ref
    ``img_proc.py:13-65``). The mask half reproduces cv2's uint8
    ``GaussianBlur`` in 8-bit fixed point, so it is bit-exact; the ROI
    follows cv2's ``fillConvexPoly`` (LINE_8 outline, fixed-point scan),
    the largest contour cv2's ``findContours`` border tracing and
    ``contourArea``.
  - ``checkerboard``, ``create_gray_pattern``, ``create_number_pattern``:
    calibration and sync-test patterns.
  - montage helpers for the result summaries: ``make_grid``,
    ``resize_area_np``, ``resize_linear_np`` (cv2's default bilinear
    ``resize``), ``to_pseudocolor`` (OpenCV's JET table, committed),
    ``insert_texts`` (Pillow's rendering of ``spaa_tpu``'s label font,
    from a committed glyph atlas).
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from spaa_tpu_torch.ops.image import _area_matrix

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


# cv2's chain-code directions (x, y): 0 right, then counter-clockwise on
# the screen (y grows downwards)
_CHAIN_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CHAIN_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def _outer_border(fg: np.ndarray, x0: int, y0: int) -> np.ndarray:
    """The outer border of the 8-connected component whose first pixel in
    raster order is (x0, y0), traced as ``cv2.findContours`` traces it
    (Suzuki-Abe: the first neighbour clockwise from the left one, then
    counter-clockwise from the pixel came from, until the start pixel is
    re-entered from the first move). ``fg``: the bool image padded by one
    zero pixel on every side; returns the [N, 2] (x, y) points, padded."""
    for s in (3, 2, 1, 0, 7, 6, 5, 4):
        if fg[y0 + _CHAIN_DY[s], x0 + _CHAIN_DX[s]]:
            break
    else:
        return np.array([[x0, y0]])              # an isolated pixel
    x1, y1 = x0 + _CHAIN_DX[s], y0 + _CHAIN_DY[s]
    pts = []
    x3, y3 = x0, y0
    while True:
        for k in range(1, 9):
            t = (s + k) & 7
            x4, y4 = x3 + _CHAIN_DX[t], y3 + _CHAIN_DY[t]
            if fg[y4, x4]:
                break
        pts.append((x3, y3))
        if (x4, y4) == (x0, y0) and (x3, y3) == (x1, y1):
            return np.array(pts)
        x3, y3 = x4, y4
        s = (t + 4) & 7


def _component_starts(mask: np.ndarray) -> list:
    """(x, y) of the first pixel in raster order of every 8-connected
    foreground component, in raster order."""
    h, w = mask.shape
    seen = np.zeros_like(mask, bool)
    starts = []
    for y0, x0 in zip(*np.nonzero(mask)):
        if seen[y0, x0]:
            continue
        starts.append((int(x0), int(y0)))
        seen[y0, x0] = True
        stack = [(y0, x0)]
        while stack:
            y, x = stack.pop()
            for yy in range(max(y - 1, 0), min(y + 2, h)):
                for xx in range(max(x - 1, 0), min(x + 2, w)):
                    if mask[yy, xx] and not seen[yy, xx]:
                        seen[yy, xx] = True
                        stack.append((yy, xx))
    return starts


def _shoelace_area(pts: np.ndarray) -> float:
    """``cv2.contourArea``: the absolute shoelace area of a closed polygon."""
    x, y = pts[:, 0].astype(np.int64), pts[:, 1].astype(np.int64)
    return abs(int(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))) / 2.0


def _largest_contour(mask: np.ndarray) -> np.ndarray:
    """The contour ``max(cv2.findContours(mask, RETR_TREE, ...)[0],
    key=cv2.contourArea)`` picks, as (x, y) points: the outer border of
    largest area (a hole's border lies inside its component's outer
    border, so it never has the larger area). cv2 lists the outermost
    borders in reverse raster order of their first pixels and ``max`` keeps
    the first of equal areas, so a tie goes to the component found last
    (a component inside another's hole is listed after them: a tie of one
    with an outermost component is not followed)."""
    fg = np.pad(mask, 1)
    best, best_area = None, -1.0
    for x0, y0 in _component_starts(mask):
        pts = _outer_border(fg, x0 + 1, y0 + 1) - 1
        area = _shoelace_area(pts)
        if area >= best_area:
            best, best_area = pts, area
    return best


def _compensation_mask(im: np.ndarray) -> np.ndarray:
    """CompenNet++'s direct-light mask (ref ``img_proc.py:24-27``): the
    thresholds of a 4-class multi-Otsu on the blurred gray image, applied
    to the UNblurred one, keeping the brightest class."""
    im_u8 = _rgb2gray_u8(im)
    ths = multi_otsu(_gaussian_blur3_u8(im_u8), classes=4)
    return np.digitize(im_u8, bins=ths) > 2


def threshold_im(im_in: np.ndarray, compensation: bool = False):
    """Direct-light binary mask, ROI and bounding-box corners.

    im_in: HxWx3 float in [0, 1], or an HxW bool mask. Returns
    (im_mask [H, W] bool, im_roi [H, W] bool, corners: 4 [x, y] in [-1, 1]
    grid coordinates). The ROI is the filled convex hull and the corners
    the bounding box (cv2 ``boundingRect``'s inclusive width: ``x + w`` is
    one past the last column) of the contour points: of every contour,
    i.e. the whole foreground, or with ``compensation`` (CompenNet++'s
    mask, 4-class Otsu) of the largest contour only."""
    if im_in.ndim == 3:
        im_mask = (_compensation_mask(im_in) if compensation
                   else direct_light_mask(im_in))
    elif im_in.dtype == bool:
        im_mask = im_in
    else:
        raise ValueError("expected HxWx3 float or HxW bool")
    if not im_mask.any():
        raise ValueError("threshold_im: the mask has no foreground pixel")
    if compensation:
        pts = _largest_contour(im_mask)
    else:
        # each foreground row's two extreme pixels span the same hull as
        # all foreground (and contour) pixels
        rows = np.flatnonzero(im_mask.any(axis=1))
        first = im_mask[rows].argmax(axis=1)
        last = im_mask.shape[1] - 1 - im_mask[rows, ::-1].argmax(axis=1)
        pts = np.concatenate([np.stack([first, rows], 1),
                              np.stack([last, rows], 1)])
    im_roi = _fill_convex_poly(im_mask.shape, _convex_hull(pts)) > 0

    x, y = (int(v) for v in pts.min(axis=0))
    x2, y2 = (int(v) + 1 for v in pts.max(axis=0))
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


def create_gray_pattern(w: int, h: int) -> np.ndarray:
    """Gray-code structured-light patterns -> (N, h, w, 3) uint8
    (ref ``img_proc.py:135-171``; generated by the capture workflow,
    unused by SPAA itself)."""
    nbits = np.ceil(np.log2([w, h])).astype(int)
    offset = (2 ** nbits - np.array([w, h])) // 2

    c, r = np.meshgrid(np.arange(w), np.arange(h))
    coords = [c + offset[0], r + offset[1]]
    bin_patterns = []
    for axis in range(2):
        v = coords[axis].astype(np.uint16)
        bits = ((v[..., None] >> np.arange(nbits[axis])) & 1).astype(np.uint8)
        bin_patterns.append(bits[..., ::-1])  # MSB first

    gray_patterns = []
    for bp in bin_patterns:
        gp = bp.copy()
        for i in range(1, bp.shape[-1]):
            gp[..., i] = np.bitwise_xor(bp[..., i - 1], bp[..., i])
        gray_patterns.append(gp)

    num = 2 * int(nbits.sum()) + 2
    pats = np.zeros((h, w, num), np.uint8)
    pats[:, :, 0] = 1
    k = 2
    for gp in gray_patterns:
        for i in range(gp.shape[-1]):
            pats[:, :, k] = gp[..., i]
            pats[:, :, k + 1] = 1 - gp[..., i]
            k += 2
    pats *= 255
    return np.transpose(np.tile(pats[..., None], (1, 1, 1, 3)), (2, 0, 1, 3))


def create_number_pattern(w: int, h: int, count: int = 10) -> np.ndarray:
    """Projector/camera sync-test "numbers" patterns -> (count, h, w, 3)
    float: mid-gray frames with a large centred index (ref ``main.py:52-61``;
    the dataset's own images are not redistributable)."""
    ims = []
    for i in range(1, count + 1):
        im = np.full((h, w, 3), 0.5, np.float32)
        text = str(i)
        font_sz = h // 2
        # roughly centred (digit glyphs are ~0.5*font_sz wide)
        x = max((w - int(0.5 * font_sz) * len(text)) // 2, 0)
        y = max((h - font_sz) // 2 - font_sz // 8, 0)
        ims.append(insert_text(im, text, (x, y), font_sz,
                               color=(255, 255, 255)))
    return np.stack(ims, 0)


# ------------------------------------------------------------------ text
_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
FONT_ATLAS = os.path.join(_ASSETS, "font", "atlas.npz")
JET_TABLE = os.path.join(_ASSETS, "jet_colormap.npy")


@functools.lru_cache(maxsize=1)
def _atlas():
    """The committed glyph atlas (``tools/make_torch_font_atlas.py``):
    meta, and per character (bitmap, left, top, advance)."""
    with np.load(FONT_ATLAS) as a:
        meta = json.loads(str(a["meta"]))
        pix = a["pixels"]
        glyphs = {}
        for k, code in enumerate(a["chars"]):
            s, h, w = int(a["start"][k]), int(a["height"][k]), \
                int(a["width"][k])
            glyphs[chr(int(code))] = (
                pix[s:s + h * w].reshape(h, w).astype(np.int32),
                int(a["left"][k]), int(a["top"][k]), int(a["advance"][k]))
    return meta, glyphs


def font_glyphs(font_sz: int) -> dict:
    """The glyphs ``spaa_tpu`` draws at requested size ``font_sz``; raises
    for a size the atlas does not cover (no other font stands in)."""
    meta, glyphs = _atlas()
    if int(font_sz) not in meta["sizes"]:
        raise ValueError(
            f"the font atlas ({meta['font']}) does not cover size {font_sz}; "
            f"it covers {meta['sizes'][0]}-{meta['sizes'][-1]} "
            "(tools/make_torch_font_atlas.py)")
    return glyphs


def render_text_mask(text: str, glyphs: dict):
    """Coverage mask of ``text`` and its top-left offset from the pen
    origin, composed as Pillow's BASIC layout does: integer advances, no
    kerning, overlapping glyphs merged as a + round(b * (255 - a) / 255)."""
    pen, placed = 0, []
    for ch in text:
        try:
            bm, left, top, adv = glyphs[ch]
        except KeyError:
            raise ValueError(f"the font atlas has no glyph for {ch!r}") \
                from None
        if bm.size:
            placed.append((bm, pen + left, top))
        pen += adv
    if not placed:
        return np.zeros((0, 0), np.int32), (0, 0)
    x0 = min(x for _, x, _ in placed)
    y0 = min(y for _, _, y in placed)
    x1 = max(x + b.shape[1] for b, x, _ in placed)
    y1 = max(y + b.shape[0] for b, _, y in placed)
    canvas = np.zeros((y1 - y0, x1 - x0), np.int32)
    for bm, x, y in placed:
        sub = canvas[y - y0:y - y0 + bm.shape[0], x - x0:x - x0 + bm.shape[1]]
        t = bm * (255 - sub) + 128
        sub += ((t >> 8) + t) >> 8
    return canvas, (x0, y0)


def _draw_text(im: np.ndarray, text: str, pos, color, glyphs) -> None:
    """Blend ``color`` through the text's mask into uint8 HWC ``im`` in
    place, clipped to the image: out = (in * (255 - m) + ink * m) / 255,
    rounded as Pillow's ``draw_bitmap`` does."""
    mask, (ox, oy) = render_text_mask(text, glyphs)
    x, y = int(pos[0]) + ox, int(pos[1]) + oy
    h, w = im.shape[:2]
    ya, yb = max(y, 0), min(y + mask.shape[0], h)
    xa, xb = max(x, 0), min(x + mask.shape[1], w)
    if ya >= yb or xa >= xb:
        return
    m = mask[ya - y:yb - y, xa - x:xa - x + (xb - xa), None]
    region = im[ya:yb, xa:xb].astype(np.int32)
    ink = np.asarray(color, np.int32)[:im.shape[2]]
    t = region * (255 - m) + ink * m + 128
    im[ya:yb, xa:xb] = ((t >> 8) + t) >> 8


def insert_text(im_hwc: np.ndarray, text: str, pos, font_sz: int = 14,
                color=(0, 0, 0)) -> np.ndarray:
    """Annotate an HWC float image with text (ref ``img_proc.py:174-190``)."""
    return insert_texts(im_hwc, [(text, pos, color)], font_sz)


def expand_border(im_hwc: np.ndarray, border=(0, 20, 0, 0),
                  fill=(255, 255, 255)) -> np.ndarray:
    """Pad borders (left, top, right, bottom) (ref ``img_proc.py:193-197``);
    float in, float out."""
    im = _pad_u8(np.uint8(np.clip(im_hwc, 0, 1) * 255), border, fill)
    return im.astype(np.float32) / 255.0


def _pad_u8(im: np.ndarray, border, fill) -> np.ndarray:
    left, top, right, bottom = (int(b) for b in border)
    h, w, c = im.shape
    out = np.empty((h + top + bottom, w + left + right, c), np.uint8)
    out[...] = np.asarray(fill, np.uint8)[:c]
    out[top:top + h, left:left + w] = im
    return out


def insert_texts(im_hwc: np.ndarray, items, font_sz: int = 14,
                 border=None, fill=(255, 255, 255),
                 as_uint8: bool = False) -> np.ndarray:
    """Optional border, then every ``(text, (x, y), color)`` drawn in the
    font ``spaa_tpu`` draws at ``font_sz`` (the committed atlas), equal to
    its Pillow rendering byte for byte. A uint8 image with ``as_uint8``
    stays uint8; otherwise float [0, 1] in and out."""
    glyphs = font_glyphs(font_sz)
    im = im_hwc if im_hwc.dtype == np.uint8 \
        else np.uint8(np.clip(im_hwc, 0, 1) * 255)
    im = _pad_u8(im, border, fill) if border is not None else im.copy()
    for text, pos, color in items:
        _draw_text(im, text, pos, color, glyphs)
    return im if as_uint8 else im.astype(np.float32) / 255.0


# --------------------------------------------------------------- montage
def _linear_taps(n_in: int, n_out: int):
    """Source indices (two per output, clamped) and float32 weights of
    cv2's bilinear resize along one axis: half-pixel centres and the
    fraction in float64, the scale as ``1 / (n_out / n_in)``, a source
    position before the first pixel or at or after the last one taking
    that pixel alone."""
    fx = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[(sx < 0) | (sx >= n_in - 1)] = 0.0
    sx = np.clip(sx, 0, n_in - 1)
    return (sx, np.minimum(sx + 1, n_in - 1), (1.0 - fx).astype(np.float32),
            fx.astype(np.float32))


def resize_linear_np(src: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(src, dsize=(w, h)) with its default ``INTER_LINEAR`` of
    an HxW[xC] float image: rows first, then columns, in float32."""
    w, h = int(dsize[0]), int(dsize[1])
    s = np.asarray(src, np.float32)
    if s.shape[:2] == (h, w):
        return s.copy()
    x0, x1, xa, xb = _linear_taps(s.shape[1], w)
    y0, y1, ya, yb = _linear_taps(s.shape[0], h)
    tail = (None,) * (s.ndim - 2)
    col = (None, slice(None)) + tail
    t = s[:, x0] * xa[col] + s[:, x1] * xb[col]
    row = (slice(None), None) + tail
    return t[y0] * ya[row] + t[y1] * yb[row]


def resize_area_np(x: np.ndarray, size) -> np.ndarray:
    """Host numpy twin of :func:`spaa_tpu_torch.ops.image.resize_area`
    (the same averaging matrices, two BLAS products; ref
    ``spaa_tpu/utils/imgproc_host.py::resize_area_np``). NHWC/HWC/HW."""
    th, tw = int(size[0]), int(size[1])
    x = np.asarray(x, np.float32)
    squeeze_to = x.ndim
    if x.ndim == 2:
        x = x[..., None]
    if x.ndim == 3:
        x = x[None]
    n, h, w, c = x.shape
    if (h, w) != (th, tw):
        ah = _area_matrix(h, th)                      # [th, h]
        aw = _area_matrix(w, tw)                      # [tw, w]
        x = np.matmul(ah, x.reshape(n, h, w * c)).reshape(n, th, w, c)
        x = np.matmul(aw, x)                          # aw @ [w, c] per n, th
    if squeeze_to == 3:
        return x[0]
    if squeeze_to == 2:
        return x[0, ..., 0]
    return x


@functools.lru_cache(maxsize=1)
def _jet() -> np.ndarray:
    return np.load(JET_TABLE)


def to_pseudocolor(x: np.ndarray) -> np.ndarray:
    """Min-max normalise + JET colormap of an HxW array -> HWC float RGB
    (ref ``img_proc.py:200-207``), from OpenCV's table
    (``tools/make_torch_jet_table.py``)."""
    x = np.squeeze(np.asarray(x)).astype(np.float32)
    x = (x - x.min()) / max(x.max() - x.min(), 1e-12)
    return _jet()[np.uint8(x * 255)].astype(np.float32) / 255.0


def montage(im_in: np.ndarray, grid_shape=None, padding_width: int = 5,
            fill=(1, 1, 1)) -> np.ndarray:
    """Auto-square-grid montage of NHWC images (ref ``utils.py:301-331``:
    rows = ceil(sqrt(N)), cols = ceil(N/rows); also takes the reference's
    (H, W, C, N) layout)."""
    im = np.asarray(im_in)
    assert im.ndim == 4, "requires a 4-D array"
    if im.shape[-1] not in (1, 3) and im.shape[-2] in (1, 3):
        im = im.transpose(3, 0, 1, 2)      # (H, W, C, N) -> (N, H, W, C)
    n = im.shape[0]
    if grid_shape is None:
        rows = int(np.ceil(np.sqrt(n)))
        cols = int(np.ceil(n / rows))
    else:
        rows, cols = grid_shape
    return _grid(im, rows, cols, padding_width,
                 np.asarray(fill, im.dtype)[:im.shape[-1]],
                 lambda k: divmod(k, cols))


def _grid(imgs: np.ndarray, nr: int, ncol: int, padding: int, pad_value,
          place) -> np.ndarray:
    n, h, w, c = imgs.shape
    grid = np.full((nr * (h + padding) + padding,
                    ncol * (w + padding) + padding, c), pad_value, imgs.dtype)
    for k in range(n):
        r, col = place(k)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0:y0 + h, x0:x0 + w] = imgs[k]
    return grid


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile NHWC images row by row into one HWC image (torchvision's
    ``make_grid``, used by ``attack_results``)."""
    imgs = np.asarray(images)
    ncol = min(nrow, imgs.shape[0])
    nr = int(np.ceil(imgs.shape[0] / ncol))
    return _grid(imgs, nr, ncol, padding, pad_value,
                 lambda k: divmod(k, ncol))


def make_grid_transposed(images: np.ndarray, nrow: int = 8,
                         padding: int = 2,
                         pad_value: float = 0.0) -> np.ndarray:
    """Column-major :func:`make_grid` (ref ``utils.py:334-416``): image k
    at (row k % nrow, column k // nrow)."""
    imgs = np.asarray(images)
    nr = min(nrow, imgs.shape[0])
    ncol = int(np.ceil(imgs.shape[0] / nr))
    return _grid(imgs, nr, ncol, padding, pad_value,
                 lambda k: divmod(k, nr)[::-1])
