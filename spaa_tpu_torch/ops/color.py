"""Differentiable sRGB -> CIELAB and CIEDE2000 maps (counterpart of
``spaa_tpu/ops/color.py``, reference ``perc_al/differential_color_functions.py``).

NHWC ``[..., 3]`` in and out. The reference's constants and masks are kept
(0.0405 linearisation threshold, +1e-4 epsilons, zero-chroma masks, the
39-degree T-term). ``torch.where`` differentiates both branches and an inf
in the unused one turns into NaN (0 * inf), so the two power laws are
``autograd.Function``s whose derivatives reuse the forward value, exactly
like ``spaa_tpu``'s ``custom_jvp``s; torch also has no ``cbrt``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_RGB2XYZ = np.array([[0.4124, 0.3576, 0.1805],
                     [0.2126, 0.7152, 0.0722],
                     [0.0193, 0.1192, 0.9504]], np.float32)
_XN, _YN, _ZN = 95.0489, 100.0, 108.8840


class _SrgbGamma(torch.autograd.Function):
    """((x + 0.055) / 1.055) ** 2.4, d/dx = 2.4 y / (x + 0.055)."""

    @staticmethod
    def forward(ctx, x):
        y = ((x + 0.055) / 1.055) ** 2.4
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (2.4 * y / (x + 0.055))


class _Cbrt(torch.autograd.Function):
    """Real cube root, d/dx = 1 / (3 y^2)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (3.0 * y * y)


def _xyz_lab_f(t: torch.Tensor) -> torch.Tensor:
    is_zero = (t == 0.0).to(t.dtype)
    t_safe = t + 1e-4 * is_zero
    f = torch.where(t_safe > 0.008856, _Cbrt.apply(t_safe),
                    7.787 * t_safe + 16.0 / 116.0)
    return f * (1.0 - is_zero)


def _linear(c: torch.Tensor) -> torch.Tensor:
    return 100.0 * torch.where(c > 0.0405, _SrgbGamma.apply(c), c / 12.92)


def _rgb2xyz_channels(rgb: torch.Tensor):
    rl, gl, bl = _linear(rgb[..., 0]), _linear(rgb[..., 1]), _linear(rgb[..., 2])
    m = _RGB2XYZ.astype(np.float64)
    return tuple(float(m[i, 0]) * rl + float(m[i, 1]) * gl
                 + float(m[i, 2]) * bl for i in range(3))


def rgb2xyz(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [..., 3] in [0, 1] -> XYZ scaled by 100 (ref ``:12-24``)."""
    return torch.stack(_rgb2xyz_channels(rgb), dim=-1)


def rgb2lab_diff(rgb: torch.Tensor) -> torch.Tensor:
    """Differentiable sRGB [..., 3] in [0, 1] -> CIELAB [..., 3]."""
    x, y, z = _rgb2xyz_channels(rgb)
    fx, fy, fz = _xyz_lab_f(x / _XN), _xyz_lab_f(y / _YN), _xyz_lab_f(z / _ZN)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def _pow7(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x2 * x


def _deg(x):
    return x * (180.0 / math.pi)


def _rad(x):
    return x * (math.pi / 180.0)


def _hpf(x, y):
    """Hue angle in degrees in [0, 360), masked at (0, 0)."""
    nz = 1.0 - ((x == 0) & (y == 0)).to(x.dtype)
    h = _deg(torch.atan2(x * nz, y * nz))
    return torch.where(h >= 0, h, h + 360.0) * nz + 0.0


def _dhpf(c1, c2, h1p, h2p):
    nz = 1.0 - ((c1 * c2) == 0).to(c1.dtype)
    d = h2p - h1p
    d = torch.where(d > 180.0, d - 360.0, torch.where(d < -180.0, d + 360.0, d))
    return d * nz


def _ahpf(c1, c2, h1p, h2p):
    zero = ((c1 * c2) == 0).to(c1.dtype)
    nz = 1.0 - zero
    near = (torch.abs(h2p - h1p) <= 180.0).to(c1.dtype)
    far = 1.0 - near
    wrap_lo = (torch.abs(h2p + h1p) < 360.0).to(c1.dtype)
    s = h1p + h2p
    res = s * nz * near + (s + 360.0) * nz * far * wrap_lo \
        + (s - 360.0) * nz * far * (1.0 - wrap_lo)
    res = res + res * zero
    return res * 0.5


def ciede2000_diff(lab1: torch.Tensor, lab2: torch.Tensor,
                   standard: bool = False) -> torch.Tensor:
    """CIEDE2000 map [N, H, W] of two CIELAB [N, H, W, 3] images. The
    default keeps the reference's ``cos(h - 39 deg)`` T-term; ``standard``
    uses the textbook 30 degrees."""
    l1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    l2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]
    zero1 = ((a1 == 0) & (b1 == 0)).to(l1.dtype)
    zero2 = ((a2 == 0) & (b2 == 0)).to(l1.dtype)
    nz1, nz2 = 1.0 - zero1, 1.0 - zero2
    b1 = b1 + 1e-4 * zero1
    b2 = b2 + 1e-4 * zero2

    c1 = torch.sqrt(a1 * a1 + b1 * b1)
    c2 = torch.sqrt(a2 * a2 + b2 * b2)
    ac7 = _pow7((c1 + c2) / 2.0)
    g = 0.5 * (1.0 - torch.sqrt(ac7 / (ac7 + 25.0 ** 7.0)))
    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = torch.sqrt(a1p * a1p + b1 * b1)
    c2p = torch.sqrt(a2p * a2p + b2 * b2)

    h1p = _hpf(b1, a1p) * nz1
    h2p = _hpf(b2, a2p) * nz2
    dlp = l2 - l1
    dcp = c2p - c1p
    dhp = _dhpf(c1, c2, h1p, h2p)
    # sqrt-at-0 guard, as in spaa_tpu: c1p*c2p can underflow to 0
    dhp_big = 2.0 * torch.sqrt(torch.clamp(c1p * c2p, min=1e-30)) \
        * torch.sin(_rad(dhp) / 2.0)
    nz_both = 1.0 - torch.maximum(zero1, zero2)
    dhp_big = dhp_big * nz_both

    al = (l1 + l2) / 2.0
    acp = (c1p + c2p) / 2.0
    ahp = _ahpf(c1, c2, h1p, h2p)
    t_shift = 30.0 if standard else 39.0
    t = (1.0 - 0.17 * torch.cos(_rad(ahp - t_shift))
         + 0.24 * torch.cos(_rad(2.0 * ahp))
         + 0.32 * torch.cos(_rad(3.0 * ahp + 6.0))
         - 0.2 * torch.cos(_rad(4.0 * ahp - 63.0)))
    dro_arg = (ahp - 275.0) / 25.0
    dro = 30.0 * torch.exp(-(dro_arg * dro_arg))
    acp7 = _pow7(acp)
    rc = torch.sqrt(acp7 / (acp7 + 25.0 ** 7.0))
    al50sq = (al - 50.0) * (al - 50.0)
    sl = 1.0 + 0.015 * al50sq / torch.sqrt(20.0 + al50sq)
    sc = 1.0 + 0.045 * acp
    sh = 1.0 + 0.015 * acp * t
    rt = -2.0 * rc * torch.sin(_rad(2.0 * dro))

    term_l = dlp / sl
    term_c = dcp / sc
    term_h = dhp_big / sh
    res_sq = (term_l * term_l + term_c * term_c * nz_both
              + term_h * term_h * nz_both + rt * term_c * term_h * nz_both)
    nonpos = (res_sq <= 0).to(res_sq.dtype)
    return torch.sqrt(res_sq + 1e-4 * nonpos) * (1.0 - nonpos)


def deltaE(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Scalar mean CIEDE2000 between two NHWC RGB images (ref
    ``differential_color_functions.py:183-190``)."""
    return torch.mean(ciede2000_diff(rgb2lab_diff(x), rgb2lab_diff(y)))
