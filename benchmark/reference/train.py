"""PCNet's training step in plain PyTorch, as the published
``train_network.py`` trains it: PCNet with its warp grid computed from the
parameters each step, the l1 + SSIM loss against the capture, and Adam over
three groups (affine + TPS theta at 1e-2, the grid refiner at 5e-3, the
shading net at 1e-3 with L2 weight decay 1e-4 added to the gradient), each
rate scaled by 0.2 from its own milestone (100, 1200, 1800 updates of the
schedule).
"""

from __future__ import annotations

import torch

from benchmark.reference.pcnet import pcnet, warp_grid
from benchmark.reference.ssim import ssim

BETAS, EPS = (0.9, 0.999), 1e-8
GROUPS = (("aff_tps", 1e-2, 100, 0.0), ("refine", 5e-3, 1200, 0.0),
          ("shading", 1e-3, 1800, 1e-4))
DROP = 0.2


def group_of(name: str) -> str:
    if name.startswith("warping_net."):
        return "aff_tps" if name.split(".")[-1] in ("affine_mat", "theta") \
            else "refine"
    return "shading"


def loss_fn(p, mask, scene, prj, cam_gt):
    """(l1 + (1 - SSIM), l2) of PCNet's image of ``prj`` against
    ``cam_gt`` (NHWC in [0, 1])."""
    grid = warp_grid(p, cam_gt.shape[1:3])
    infer = pcnet(p, grid, mask, scene, prj)
    l1 = torch.mean(torch.abs(infer - cam_gt))
    return l1 + (1.0 - ssim(infer, cam_gt)), torch.mean((infer - cam_gt) ** 2)


def train_steps(p0: dict, mask, scene, batches, moments=None, t0: int = 0,
                k0: int = 0):
    """Adam steps from parameters ``p0`` over ``batches`` [(prj, cam)]:
    ``moments`` (first, second; zeros when None) after ``t0`` updates, the
    schedule at update ``k0``. Returns ``(losses, first_grads, params,
    moments)``: each step's loss, the gradient of the first step as Adam
    takes it (weight decay included), the parameters and moments after the
    last step."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        m = {k: t.detach().clone() for k, t in moments[0].items()}
        v2 = {k: t.detach().clone() for k, t in moments[1].items()}
    rate = {g: (lr, ms, wd) for g, lr, ms, wd in GROUPS}
    losses, first = [], {}
    for i, (prj, cam) in enumerate(batches):
        leaves = {n: t.requires_grad_(True) for n, t in p.items()}
        loss, _ = loss_fn(leaves, mask, scene, prj, cam)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        k, t = k0 + i, t0 + i + 1
        with torch.no_grad():
            new = {}
            for (n, w), g in zip(leaves.items(), grads):
                lr, ms, wd = rate[group_of(n)]
                lr = lr * (DROP if k >= ms else 1.0)
                g = g + wd * w if wd else g
                m[n] = BETAS[0] * m[n] + (1 - BETAS[0]) * g
                v2[n] = BETAS[1] * v2[n] + (1 - BETAS[1]) * g * g
                mh = m[n] / (1 - BETAS[0] ** t)
                vh = v2[n] / (1 - BETAS[1] ** t)
                new[n] = w - lr * mh / (torch.sqrt(vh) + EPS)
                if i == 0:
                    first[n] = g.clone()
            p = new
    return losses, first, p, (m, v2)
