"""Image I/O on a small PNG codec (counterpart of ``spaa_tpu/utils/io.py``).

The GPU machine has neither OpenCV nor Pillow, so PNGs are decoded and
encoded here with ``zlib`` and ``struct``. The decoder takes 8-bit
grayscale, RGB and RGBA images without interlacing and all five row
filters (libpng, and so ``cv2.imwrite``, picks a filter per row). The
encoder writes 8-bit RGB with filter 0 on every row. File names follow the
reference's ``img_%04d.png`` layout, numbered from ``idx + 1``.
"""

from __future__ import annotations

import os
import struct
import zlib
from os.path import join
from typing import Optional, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # PNG colour type -> samples per pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:                                    # None
            cur = line.copy()
        elif ftype == 1:                                  # Sub
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ftype == 2:                                  # Up
            cur = line + prior
        elif ftype in (3, 4):                             # Average, Paeth
            cur = np.empty(stride, np.uint8)
            up = prior.astype(np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            filt = line.astype(np.int32)
            for x in range(0, stride, bpp):
                b = up[x:x + bpp]
                if ftype == 3:
                    pred = (left + b) >> 1
                else:
                    p = left + b - upleft
                    pa, pb, pc = np.abs(p - left), np.abs(p - b), \
                        np.abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, b, upleft))
                left = (filt[x:x + bpp] + pred) & 0xFF
                upleft = b
                cur[x:x + bpp] = left
        else:
            raise ValueError(f"unknown PNG row filter {int(ftype)}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HWC uint8 array (RGB, RGBA or single-channel)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}")
    c = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return px.reshape(h, w, c)


def encode_png(im_u8: np.ndarray) -> bytes:
    """HWC (or HW) uint8 -> PNG bytes (8-bit, filter 0 on every row)."""
    im = np.ascontiguousarray(im_u8, np.uint8)
    if im.ndim == 2:
        im = im[..., None]
    h, w, c = im.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          im.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def imread_u8(filename: str) -> np.ndarray:
    """Read one image -> HWC uint8 RGB (alpha dropped, gray expanded)."""
    with open(filename, "rb") as f:
        im = decode_png(f.read())
    if im.shape[-1] == 1:
        im = np.repeat(im, 3, axis=-1)
    return im[..., :3]


def imread(filename: str) -> np.ndarray:
    """Read one image -> HWC float32 RGB in [0, 1]."""
    return imread_u8(filename).astype(np.float32) / 255.0


def imread_dir(img_dir: str, index: Optional[Sequence[int]] = None,
               as_uint8: bool = False) -> np.ndarray:
    """Read a directory of PNGs (sorted by name, optionally the subset
    ``index``) -> NHWC float32 in [0, 1], or uint8 with ``as_uint8``."""
    names = sorted(os.listdir(img_dir))
    if index is not None:
        names = [names[i] for i in index]
    arr = np.stack([imread_u8(join(img_dir, n)) for n in names], 0)
    return arr if as_uint8 else arr.astype(np.float32) / 255.0


def save_imgs(im_4d, path: str, idx: int = 0) -> None:
    """Save NHWC float [0, 1] (or uint8) images as ``img_%04d.png`` from
    ``idx + 1`` (ref ``save_imgs``, ``utils.py:146-167``). Tensors are
    copied to the host first."""
    os.makedirs(path, exist_ok=True)
    if hasattr(im_4d, "detach"):
        im_4d = im_4d.detach().cpu().numpy()
    imgs = np.asarray(im_4d)
    if imgs.ndim == 3:
        imgs = imgs[None]
    if imgs.dtype != np.uint8:
        imgs = np.uint8(np.clip(imgs.astype(np.float32), 0, 1) * 255)
    for i in range(imgs.shape[0]):
        with open(join(path, f"img_{i + 1 + idx:04d}.png"), "wb") as f:
            f.write(encode_png(imgs[i]))


def make_setup_subdirs(setup_path: str) -> None:
    """Create the per-setup directory skeleton (ref ``utils.py:724-741``)."""
    for sub in ["ref", "cb"]:
        os.makedirs(join(setup_path, "prj/raw", sub), exist_ok=True)
    for sub in ["ref", "train", "test", "cb"]:
        os.makedirs(join(setup_path, "cam/raw", sub), exist_ok=True)
    os.makedirs(join(setup_path, "ret"), exist_ok=True)
