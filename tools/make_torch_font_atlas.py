#!/usr/bin/env python3
"""Dump the glyph atlas that ``spaa_tpu_torch`` draws montage labels with.

``spaa_tpu`` labels its result montages with Pillow
(``spaa_tpu/utils/imgproc_host.py::insert_texts``), through the font
``_get_font`` returns for each requested size. The GPU machine has no
Pillow, so the port draws from a table of that font's glyphs: for every
printable ASCII character its 8-bit coverage bitmap as Pillow's FreeType
renderer makes it, the bitmap's offset from the pen origin (top-left
anchor, ``la``) and the pen advance. The font's name, the requested sizes
that resolve to it and the library versions are stored with it.

The port composes a string the way Pillow's BASIC layout does (integer
pen advances, no kerning), merging overlapping glyphs as
``a + round(b * (255 - a) / 255)``
(``spaa_tpu_torch/utils/imgproc_host.py::render_text_mask``). The tool
refuses to write an atlas that this composition would not reproduce: it
checks integer advances, the absence of kerning, and every string the
montages draw (the first name of each of the 1000 ImageNet labels and the
fixed strings) against Pillow's own mask.

    python tools/make_torch_font_atlas.py            # writes the atlas
    python tools/make_torch_font_atlas.py --out /tmp/atlas.npz

Needs Pillow and both packages (it asks ``spaa_tpu``'s ``_get_font``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from os.path import abspath, dirname, join

import numpy as np

REPO = dirname(dirname(abspath(__file__)))
DEFAULT_OUT = join(REPO, "spaa_tpu_torch", "assets", "font", "atlas.npz")
CHARS = [chr(c) for c in range(32, 127)]
SIZES = list(range(1, 257))
FIXED_STRINGS = [
    "Cam-captured scene (10)", "Model inferred adversarial projection",
    "Model inferred cam-captured projection", "Real cam-captured projection",
    "Normalized difference, i.e., 4th-1st", "L2=123.45", "(0.99)",
    "0123456789", "Valid PSNR 12.34"]


def label_names(repo: str = REPO) -> list:
    """First name of each of the 1000 ImageNet labels (what the montages
    print), from the packaged label file."""
    with open(join(repo, "data", "imagenet1000_clsidx_to_labels.json")) as f:
        return [v.split(",")[0] for v in json.load(f).values()]


def _mask(font, text):
    m, off = font.getmask2(text, "L")
    w, h = m.size
    return np.array(m, np.uint8).reshape(h, w), (int(off[0]), int(off[1]))


def _face_key(font):
    return (font.getname(), float(font.size), int(font.layout_engine))


def _same_mask(a, a_off, b, b_off) -> bool:
    """Equal as placed bitmaps: every nonzero pixel of one lies at the
    same place with the same value in the other."""
    def nz(m, off):
        ys, xs = np.nonzero(m)
        return {(int(y) + off[1], int(x) + off[0]): int(m[y, x])
                for y, x in zip(ys, xs)}
    return nz(a, a_off) == nz(b, b_off)


def build_atlas() -> dict:
    sys.path.insert(0, REPO)
    import PIL
    from PIL import features

    from spaa_tpu.utils.imgproc_host import _get_font
    from spaa_tpu_torch.utils.imgproc_host import render_text_mask

    fonts = {s: _get_font(s) for s in SIZES}
    keys = {_face_key(f) for f in fonts.values()}
    if len(keys) != 1:
        raise SystemExit(f"the requested sizes resolve to {len(keys)} "
                         f"fonts ({sorted(keys)}); this atlas holds one")
    font = fonts[SIZES[0]]
    if font.layout_engine != 0:
        raise SystemExit("the font lays text out with raqm; the atlas "
                         "composes the BASIC layout only")
    glyphs = {}
    for ch in CHARS:
        adv = font.getlength(ch)
        if adv != int(adv):
            raise SystemExit(f"fractional advance {adv} for {ch!r}")
        bm, (left, top) = _mask(font, ch)
        glyphs[ch] = dict(bitmap=bm, left=left, top=top, advance=int(adv))
    for a in CHARS:
        for b in CHARS:
            kern = font.getlength(a + b) - glyphs[a]["advance"] \
                - glyphs[b]["advance"]
            if kern:
                raise SystemExit(f"kerning {kern} for {a + b!r}")
    strings = label_names() + FIXED_STRINGS
    table = {ch: (g["bitmap"].astype(np.int32), g["left"], g["top"],
                  g["advance"]) for ch, g in glyphs.items()}
    for s in strings:
        if not _same_mask(*render_text_mask(s, table), *_mask(font, s)):
            raise SystemExit(f"the composition differs from Pillow for {s!r}")

    name, style = font.getname()
    meta = dict(font=f"{name} {style}", pixel_size=font.size,
                layout="basic", sizes=SIZES,
                source="spaa_tpu.utils.imgproc_host._get_font",
                pillow=PIL.__version__,
                freetype=features.version("freetype2"),
                checked_strings=len(strings))
    starts, pix = [], []
    pos = 0
    for ch in CHARS:
        bm = glyphs[ch]["bitmap"]
        starts.append(pos)
        pix.append(bm.ravel())
        pos += bm.size
    return dict(
        meta=np.array(json.dumps(meta, sort_keys=True)),
        chars=np.array([ord(c) for c in CHARS], np.int32),
        advance=np.array([glyphs[c]["advance"] for c in CHARS], np.int32),
        left=np.array([glyphs[c]["left"] for c in CHARS], np.int32),
        top=np.array([glyphs[c]["top"] for c in CHARS], np.int32),
        height=np.array([glyphs[c]["bitmap"].shape[0] for c in CHARS],
                        np.int32),
        width=np.array([glyphs[c]["bitmap"].shape[1] for c in CHARS],
                       np.int32),
        start=np.array(starts, np.int64),
        pixels=np.concatenate(pix).astype(np.uint8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    atlas = build_atlas()
    os.makedirs(dirname(abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **atlas)
    meta = json.loads(str(atlas["meta"]))
    print(f"wrote {args.out}: {len(CHARS)} glyphs of {meta['font']} "
          f"({meta['pixel_size']} px, sizes {meta['sizes'][0]}-"
          f"{meta['sizes'][-1]} requested), {meta['checked_strings']} "
          "strings checked against Pillow")
    return 0


if __name__ == "__main__":
    sys.exit(main())
