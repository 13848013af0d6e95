"""Plain PyTorch SPAA (Algorithm 1 of Huang & Ling, IEEE VR 2022; the
published ``projector_based_attack.py`` ``spaa()``), per sample.

Each sample has its own stealth weights (prjl2, caml2, camdE), threshold
d_thr, target and targeted flag. One iteration: the camera image through
PCNet; the adversarial gradient of the target's raw logit (ascent when
targeted, descent on the true class when not); the colour gradient of
caml2 and CIEDE2000 between the camera image and the scene; the masks
(success, confidence over ``p_thresh`` for targeted samples, perturbation
over d_thr); a successful, perceptible sample takes the colour step at
``col_lr``, every other the adversarial step at ``adv_lr``, each
normalised per sample. The best projection is kept where the attack
succeeds, or where the colour loss drops below the best so far among the
successful, perceptible ones.

:func:`step` returns both candidate steps and the decision margins, so a
check can accept either step where a decision is a tie to rounding.
:func:`attack` runs the whole loop (the control runs it in the program's
place).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.color import ciede2000, rgb2lab


class Hyper(NamedTuple):
    iters: int = 50
    adv_lr: float = 2.0
    col_lr: float = 1.0
    adv_w: float = 1.0
    p_thresh: float = 0.9


def per_sample_l2(diff):
    """Mean over pixels of the per-pixel channel L2 norm, [B]."""
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12)).mean(
        dim=(1, 2))


def normalized(g):
    n = torch.sqrt((g * g).sum(dim=(1, 2, 3), keepdim=True))
    return g / torch.clamp(n, min=1e-12)


def colour_losses(cam, scene, weights):
    """(caml2 [B], camdE [B]): camdE only where its weight is non-zero."""
    caml2 = per_sample_l2(scene - cam)
    camde = torch.zeros_like(caml2)
    on = weights[:, 2] != 0
    if bool(on.any()):
        lab_s = rgb2lab(scene)
        d = ciede2000(rgb2lab(cam[on]), lab_s.expand(int(on.sum()), -1, -1,
                                                      -1))
        camde = camde.masked_scatter(on, d.mean(dim=(1, 2)))
    return caml2, camde


def margins(raw, caml2, target, targeted, d_thr, hp: Hyper):
    """The three decisions as signed margins (positive = true): success
    (targeted: the target's logit over every other; untargeted: the best
    other logit over the true class's), confidence (top probability minus
    ``p_thresh``) and perturbation (caml2 x 255 minus d_thr)."""
    t = raw.gather(1, target[:, None])[:, 0]
    others = raw.scatter(1, target[:, None], float("-inf")).max(1).values
    succ = torch.where(targeted, t - others, others - t)
    conf = torch.softmax(raw, 1).max(1).values - hp.p_thresh
    pert = caml2 * 255.0 - d_thr
    return succ, conf, pert


def best_adv(succ, conf, pert, targeted):
    return (succ > 0) & (pert > 0) & ((conf > 0) | ~targeted)


def step(pcnet_fn, logits_fn, scene, prj, prj_init, target, targeted,
         weights, d_thr, b_full: int, hp: Hyper):
    """One iteration from the unclamped projections ``prj`` [R, Hp, Wp, 3]
    of R samples of a batch of ``b_full``. Returns a dict: ``cam``,
    ``raw``, ``caml2``, ``camde``, ``prjl2``, the margins ``succ``, ``conf``,
    ``pert``, the mask ``m`` and the two candidate next projections
    ``next_adv`` and ``next_col``."""
    p = prj.detach().requires_grad_(True)
    cam = pcnet_fn(torch.clamp(p, 0.0, 1.0))
    c = cam.detach().requires_grad_(True)
    raw = logits_fn(c)
    sign = torch.where(targeted, -1.0, 1.0).to(raw.dtype)
    adv = (hp.adv_w * sign * raw.gather(1, target[:, None])[:, 0]).sum()
    g_adv, = torch.autograd.grad(adv / b_full, c)
    caml2, camde = colour_losses(c, scene, weights)
    col_cam = weights[:, 1] * caml2 + weights[:, 2] * camde
    g_col, = torch.autograd.grad(col_cam.sum() / b_full, c)
    q = prj.detach().requires_grad_(True)
    g_prjl2, = torch.autograd.grad(
        (weights[:, 0] * per_sample_l2(prj_init - q)).sum() / b_full, q)
    gp_adv, = torch.autograd.grad(cam, p, g_adv, retain_graph=True)
    gp_col, = torch.autograd.grad(cam, p, g_col)
    with torch.no_grad():
        raw = raw.detach()
        prjl2 = per_sample_l2(prj_init - prj)
        succ, conf, pert = margins(raw, caml2.detach(), target, targeted,
                                   d_thr, hp)
        return dict(
            cam=cam.detach(), raw=raw, caml2=caml2.detach(),
            camde=camde.detach(), prjl2=prjl2, succ=succ, conf=conf, pert=pert,
            m=best_adv(succ, conf, pert, targeted),
            next_adv=prj - hp.adv_lr * normalized(gp_adv),
            next_col=prj - hp.col_lr * normalized(gp_col + g_prjl2))


def attack(pcnet_fn, logits_fn, scene, prj_init, target, targeted, weights,
           d_thr, hp: Hyper):
    """The whole loop on a batch; returns (cam_best, clamp(prj_best))."""
    b = prj_init.shape[0]
    prj = prj_best = prj_init
    cam_best = scene.expand(b, -1, -1, -1).contiguous()
    col_best = torch.full((b,), 1e6, dtype=prj_init.dtype,
                          device=prj_init.device)
    for _ in range(hp.iters):
        s = step(pcnet_fn, logits_fn, scene, prj, prj_init, target, targeted,
                 weights, d_thr, b, hp)
        m = s["m"][:, None, None, None]
        prj = torch.where(m, s["next_col"], s["next_adv"])
        col = (weights[:, 0] * s["prjl2"] + weights[:, 1] * s["caml2"]
               + weights[:, 2] * s["camde"])
        better = (col < col_best) & s["m"]
        col_best = torch.where(better, col, col_best)
        keep = ((s["succ"] > 0) | better)[:, None, None, None]
        prj_best = torch.where(keep, prj, prj_best)
        cam_best = torch.where(keep, s["cam"], cam_best)
    return cam_best, torch.clamp(prj_best, 0.0, 1.0)
