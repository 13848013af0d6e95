"""The benchmark's own readers of the raw files both sides take: PNG
captures, the direct-light mask made from them, and the ``.flax``
(msgpack) checkpoint. Plain numpy, ``zlib`` and ``struct``; nothing of the
program under test.

The mask follows the published recipe (SPAA's ``img_proc.threshold_im``,
direct light by Nayar's separation): gray, 8 bits, a 3x3 Gaussian of sigma
1.5 in OpenCV's 8-bit fixed point, two-class Otsu.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.int32)   # row 0: the zero prior row
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        up = out[y]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(
                stride) & 0xFF
        elif ftype == 2:
            cur = (line + up) & 0xFF
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                b = up[x:x + bpp]
                pred = ((left + b) >> 1 if ftype == 3
                        else _paeth(left, b, upleft))
                left = (line[x:x + bpp] + pred) & 0xFF
                upleft = b
                cur[x:x + bpp] = left
        else:
            raise ValueError(f"unknown PNG row filter {ftype}")
        out[y + 1] = cur
    return out[1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG -> HWC uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG layout")
    c = _CHANNELS[color]
    im = _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(h, w, c)
    return np.repeat(im, 3, axis=-1) if c == 1 else im[..., :3]


def center_crop(im: np.ndarray, hw) -> np.ndarray:
    """Centre crop of an HW[C] array, offsets rounded as SPAA's
    ``img_proc.center_crop``."""
    h, w = im.shape[:2]
    i, j = int(round((h - hw[0]) / 2.0)), int(round((w - hw[1]) / 2.0))
    return im[i:i + hw[0], j:j + hw[1]]


def _otsu2(im_u8: np.ndarray) -> int:
    """The last level t of the lower class {<= t} that maximises the
    between-class variance over the 256-bin histogram."""
    p = np.bincount(im_u8.ravel(), minlength=256).astype(np.float64)
    p /= p.sum()
    w0 = np.cumsum(p)
    m0 = np.cumsum(p * np.arange(256))
    w1, m1 = 1.0 - w0, m0[-1] - m0
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where((w0 > 0) & (w1 > 0),
                         m0 * m0 / w0 + m1 * m1 / w1, -np.inf)
    return int(np.argmax(score[:255]))


def direct_light_mask(cb: np.ndarray, b: float = 0.9) -> np.ndarray:
    """[H, W] bool mask from the checkerboard captures cb [N, H, W, 3]
    (float in [0, 1]): direct light (max - min) / (1 - b), clipped, gray
    (BT.601), uint8 by truncation, 3x3 Gaussian (8-bit weights 79, 98, 79,
    reflect-101 border, rounded), two-class Otsu; the foreground is the
    levels from the threshold up (``np.digitize`` over scikit-image's
    multi-Otsu threshold, as the published code takes it)."""
    direct = np.clip((cb.max(axis=0) - cb.min(axis=0)) / (1 - b), 0, 1)
    direct = direct.astype(np.float32)
    gray = (direct[..., 0] * np.float32(0.299) + direct[..., 1]
            * np.float32(0.587) + direct[..., 2] * np.float32(0.114))
    g = np.uint8(gray * 255).astype(np.int64)
    k = np.array([79, 98, 79], np.int64)
    p = np.pad(g, 1, mode="reflect")
    r = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
    c = k[0] * r[:-2] + k[1] * r[1:-1] + k[2] * r[2:]
    smooth = ((c + (1 << 15)) >> 16).astype(np.uint8)
    return smooth >= _otsu2(smooth)


def mask_corners(mask: np.ndarray):
    """The mask's bounding box as 4 corners [x, y] in [-1, 1] grid
    coordinates (the right and bottom edges one past the last pixel)."""
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    h, w = mask.shape
    x, y, x2, y2 = cols[0], rows[0], cols[-1] + 1, rows[-1] + 1
    return [[2 * cx / w - 1, 2 * cy / h - 1]
            for cx, cy in ((x, y), (x2, y), (x2, y2), (x, y2))]


# ------------------------------------------------------------ msgpack
class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b >> 4 == 0x8:
            return self.map(b & 0x0F)
        if b >> 4 == 0x9:
            return [self.obj() for _ in range(b & 0x0F)]
        if b >> 5 == 0x5:
            return self.take(b & 0x1F).decode()
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        lengths = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H",
                   0xDB: "I", 0xDC: "H", 0xDD: "I", 0xDE: "H", 0xDF: "I",
                   0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in lengths:
            n = self.num(lengths[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode()
            if b in (0xDC, 0xDD):
                return [self.obj() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(self.num("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.num("b"), fixext[b])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.num(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int):
        """flax's ndarray (1) and numpy scalar (3) extensions: a msgpack
        (shape, dtype name, C-order bytes)."""
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack extension {code}")
        shape, dtype, buf = _Reader(self.take(n)).obj()
        arr = np.frombuffer(buf, np.dtype(dtype)).reshape(shape)
        return arr[()] if code == 3 else arr


def read_flax_checkpoint(path: str) -> dict:
    """A flax msgpack checkpoint -> nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    tree = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def flax_to_torch_names(tree: dict, prefix: str = "") -> dict:
    """Flax PCNet leaves -> ``{"<module path>.weight|bias": array}`` in
    PyTorch layouts: convolution kernels HWIO -> OIHW; transposed
    convolution kernels (stored as torch's (in, out, kh, kw) read as HWIO)
    -> (in, out, kh, kw); WarpingNet's ``affine_mat`` and ``theta`` as
    they are."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict) and "kernel" in v:
            k = v["kernel"]
            perm = (2, 3, 0, 1) if name.startswith(("transConv", "tconv")) \
                else (3, 2, 0, 1)
            out[f"{prefix}{name}.weight"] = np.ascontiguousarray(
                np.transpose(k, perm))
            out[f"{prefix}{name}.bias"] = np.asarray(v["bias"])
        elif isinstance(v, dict):
            out.update(flax_to_torch_names(v, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(v)
    return out
