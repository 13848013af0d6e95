"""Image-distance metrics: PSNR / RMSE / SSIM / L2 / L-inf / deltaE
(counterpart of ``spaa_tpu/ops/metrics.py``, reference
``utils.py:420-491``). NHWC tensors in [0, 1]. L2 and L-inf are the
"mean per-pixel channel norm x 255" definitions the SPAA tables use, and
:func:`calc_img_dists` returns the six in the reference's order."""

from __future__ import annotations

import numpy as np
import torch

from spaa_tpu_torch.ops.color import ciede2000_diff, rgb2lab_diff
from spaa_tpu_torch.ops.color import deltaE as _deltaE
from spaa_tpu_torch.ops.image import expand_4d
from spaa_tpu_torch.ops.ssim import ssim as _ssim


def _t(x) -> torch.Tensor:
    return expand_4d(torch.as_tensor(x))


def psnr_rmse_ssim(x: torch.Tensor, y: torch.Tensor):
    """(PSNR, RMSE, SSIM) as 0-d tensors on the images' device: what
    validation reports."""
    mse = torch.mean((x - y) ** 2)
    return 10.0 * torch.log10(1.0 / mse), torch.sqrt(mse * 3.0), _ssim(x, y)


def metrics_tensors(x: torch.Tensor, y: torch.Tensor):
    """(PSNR, RMSE, SSIM, L2, L-inf, deltaE) as 0-d tensors."""
    diff = x - y
    return (*psnr_rmse_ssim(x, y),
            torch.mean(torch.linalg.norm(diff, dim=-1)) * 255.0,
            torch.mean(diff.abs().amax(dim=-1)) * 255.0, _deltaE(x, y))


@torch.no_grad()
def calc_img_dists(x, y):
    """(PSNR, RMSE, SSIM, L2, L-inf, deltaE) as Python floats
    (ref ``utils.py:420-423``); NHWC or HWC in [0, 1]."""
    return tuple(float(v) for v in metrics_tensors(_t(x), _t(y)))


@torch.no_grad()
def per_sample_img_dists(x, y):
    """Per-sample metric primitives, each [N]: (mse, ssim, l2, linf, dE).
    Slice aggregates follow from them on the host
    (:func:`dists_from_per_sample`)."""
    x, y = _t(x), _t(y)
    diff = x - y
    mse = torch.mean(diff ** 2, dim=(1, 2, 3))
    ssim_s = _ssim(x, y, size_average=False)
    l2 = torch.mean(torch.linalg.norm(diff, dim=-1), dim=(1, 2)) * 255.0
    linf = torch.mean(diff.abs().amax(dim=-1), dim=(1, 2)) * 255.0
    de = torch.mean(ciede2000_diff(rgb2lab_diff(x), rgb2lab_diff(y)),
                    dim=(1, 2))
    return mse, ssim_s, l2, linf, de


def dists_from_per_sample(vals, sl=slice(None)):
    """(PSNR, RMSE, SSIM, L2, L-inf, deltaE) floats for a slice of
    :func:`per_sample_img_dists` outputs (host arithmetic)."""
    mse, ssim_s, l2, linf, de = (np.asarray(torch.as_tensor(v).cpu())[sl]
                                 for v in vals)
    m = float(mse.mean())
    with np.errstate(divide="ignore"):
        psnr_v = float(10.0 * np.log10(1.0 / m)) if m > 0 else float("inf")
    return (psnr_v, float(np.sqrt(m * 3.0)), float(ssim_s.mean()),
            float(l2.mean()), float(linf.mean()), float(de.mean()))


@torch.no_grad()
def psnr(x, y) -> float:
    return float(10.0 * torch.log10(1.0 / torch.mean((_t(x) - _t(y)) ** 2)))


@torch.no_grad()
def rmse(x, y) -> float:
    return float(torch.sqrt(torch.mean((_t(x) - _t(y)) ** 2) * 3.0))


@torch.no_grad()
def ssim(x, y) -> float:
    return float(_ssim(_t(x), _t(y)))


@torch.no_grad()
def l2_norm(x, y) -> float:
    """Mean per-pixel channel L2 norm x 255 (ref ``utils.py:459-470``)."""
    return float(torch.mean(torch.linalg.norm(_t(x) - _t(y), dim=-1)) * 255.0)


@torch.no_grad()
def linf_norm(x, y) -> float:
    """Mean per-pixel channel L-inf norm x 255 (ref ``utils.py:474-485``)."""
    return float(torch.mean((_t(x) - _t(y)).abs().amax(dim=-1)) * 255.0)


@torch.no_grad()
def deltaE(x, y) -> float:
    return float(_deltaE(_t(x), _t(y)))


def l2_norm_to_mse(x: torch.Tensor, num_chan: int) -> torch.Tensor:
    """Ref ``utils.py:489-491``."""
    x = torch.as_tensor(x)
    return torch.mean(x ** 2) / num_chan
