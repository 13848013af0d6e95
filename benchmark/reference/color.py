"""Plain PyTorch sRGB -> CIELAB and CIEDE2000, as the published PerC-AL
``differential_color_functions.py`` computes them (the attack's camdE
loss): the 0.0405 linearisation threshold, the +1e-4 guards on zero
values, zero-chroma masks, and the 39-degree T-term. NHWC in, maps out.
"""

from __future__ import annotations

import math

import torch

_M = ((0.4124, 0.3576, 0.1805), (0.2126, 0.7152, 0.0722),
      (0.0193, 0.1192, 0.9504))
_WHITE = (95.0489, 100.0, 108.8840)


def _lin(c):
    # the gamma branch of c <= 0.0405 is finite too (c + 0.055 > 0), so
    # torch.where's gradient stays finite
    return 100.0 * torch.where(c > 0.0405, ((c + 0.055) / 1.055) ** 2.4,
                               c / 12.92)


def _f(t):
    zero = (t == 0.0).to(t.dtype)
    ts = t + 1e-4 * zero
    return torch.where(ts > 0.008856, ts ** (1.0 / 3.0),
                       7.787 * ts + 16.0 / 116.0) * (1.0 - zero)


def rgb2lab(rgb):
    """[..., 3] sRGB in [0, 1] -> CIELAB [..., 3]."""
    lin = [_lin(rgb[..., i]) for i in range(3)]
    xyz = [sum(_M[r][i] * lin[i] for i in range(3)) / _WHITE[r]
           for r in range(3)]
    fx, fy, fz = (_f(v) for v in xyz)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], -1)


def _hue(b, a):
    """atan2(b, a) in degrees in [0, 360); 0 where a = b = 0."""
    nz = 1.0 - ((b == 0) & (a == 0)).to(a.dtype)
    h = torch.atan2(b * nz, a * nz) * (180.0 / math.pi)
    return torch.where(h >= 0, h, h + 360.0) * nz


def ciede2000(lab1, lab2):
    """CIEDE2000 map [...] of two CIELAB [..., 3] images."""
    l1, a1, b1 = lab1.unbind(-1)
    l2, a2, b2 = lab2.unbind(-1)
    z1 = ((a1 == 0) & (b1 == 0)).to(l1.dtype)
    z2 = ((a2 == 0) & (b2 == 0)).to(l1.dtype)
    b1, b2 = b1 + 1e-4 * z1, b2 + 1e-4 * z2
    c1 = torch.sqrt(a1 * a1 + b1 * b1)
    c2 = torch.sqrt(a2 * a2 + b2 * b2)
    cm7 = ((c1 + c2) / 2.0) ** 7
    g = 0.5 * (1.0 - torch.sqrt(cm7 / (cm7 + 25.0 ** 7)))
    a1p, a2p = (1.0 + g) * a1, (1.0 + g) * a2
    c1p = torch.sqrt(a1p * a1p + b1 * b1)
    c2p = torch.sqrt(a2p * a2p + b2 * b2)
    h1p = _hue(b1, a1p) * (1.0 - z1)
    h2p = _hue(b2, a2p) * (1.0 - z2)

    chroma0 = ((c1 * c2) == 0).to(l1.dtype)
    dh = h2p - h1p
    dh = torch.where(dh > 180.0, dh - 360.0,
                     torch.where(dh < -180.0, dh + 360.0, dh)) * (1 - chroma0)
    both = 1.0 - torch.maximum(z1, z2)
    dhh = (2.0 * torch.sqrt(torch.clamp(c1p * c2p, min=1e-30))
           * torch.sin(dh * (math.pi / 360.0))) * both

    s = h1p + h2p
    near = (torch.abs(h2p - h1p) <= 180.0).to(l1.dtype)
    low = (torch.abs(s) < 360.0).to(l1.dtype)
    hm = (1 - chroma0) * (s * near + (s + 360.0) * (1 - near) * low
                          + (s - 360.0) * (1 - near) * (1 - low))
    hm = 0.5 * (hm + hm * chroma0)

    lm = (l1 + l2) / 2.0
    cpm = (c1p + c2p) / 2.0

    def cosd(x):
        return torch.cos(x * (math.pi / 180.0))

    t = (1.0 - 0.17 * cosd(hm - 39.0) + 0.24 * cosd(2.0 * hm)
         + 0.32 * cosd(3.0 * hm + 6.0) - 0.2 * cosd(4.0 * hm - 63.0))
    dro = 30.0 * torch.exp(-(((hm - 275.0) / 25.0) ** 2))
    rc = torch.sqrt(cpm ** 7 / (cpm ** 7 + 25.0 ** 7))
    lsq = (lm - 50.0) ** 2
    sl = 1.0 + 0.015 * lsq / torch.sqrt(20.0 + lsq)
    sc = 1.0 + 0.045 * cpm
    sh = 1.0 + 0.015 * cpm * t
    rt = -2.0 * rc * torch.sin(2.0 * dro * (math.pi / 180.0))
    tl, tc, th = (l2 - l1) / sl, (c2p - c1p) / sc, dhh / sh
    sq = tl * tl + (tc * tc + th * th + rt * tc * th) * both
    nonpos = (sq <= 0).to(sq.dtype)
    return torch.sqrt(sq + 1e-4 * nonpos) * (1.0 - nonpos)
