#!/usr/bin/env python3
"""Dump OpenCV's JET colormap as the 256 x 3 RGB table ``spaa_tpu_torch``
colours montage difference panels with (``spaa_tpu`` calls
``cv2.applyColorMap(..., COLORMAP_JET)``; the GPU machine has no cv2).

    python tools/make_torch_jet_table.py     # writes the table

Needs OpenCV.
"""

from __future__ import annotations

import argparse
import sys
from os.path import abspath, dirname, join

import numpy as np

DEFAULT_OUT = join(dirname(dirname(abspath(__file__))), "spaa_tpu_torch",
                   "assets", "jet_colormap.npy")


def jet_table() -> np.ndarray:
    import cv2
    bgr = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)
    return np.ascontiguousarray(bgr[:, 0, ::-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    np.save(args.out, jet_table())
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
