"""SPAA: Stealthy Projector-based Adversarial Attack (Algorithm 1).

Counterpart of ``spaa_tpu/attack/spaa.py`` (reference
``projector_based_attack.py:212-339``), with the same re-design: the whole
(stealth loss x d_thr) sweep runs as one batch with per-sample weights,
thresholds, targets and targeted flags, and each iteration pulls ONE
camera-space cotangent back through PCNet, chosen per sample between the
adversarial and the colour gradient before the pullback. Per-sample
gradient normalisation makes both exactly equivalent to the reference's
per-config, two-backward loop.

Tensors are NHWC; ``pcnet_apply(prj) -> cam`` and ``logits_fn(cam) ->
raw logits`` are differentiable closures over frozen modules (see
``attack.orchestrate``). The loop is a Python loop over iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from spaa_tpu_torch.ops.color import ciede2000_diff, rgb2lab_diff
from spaa_tpu_torch.utils import trace


class SpaaConfig(NamedTuple):
    """Attack hyper-parameters (values ref ``projector_based_attack.py:243-258``).

    ``camde_range``: optional (lo, hi) batch slice on which the CIEDE2000
    term is computed (the samples whose camdE weight is non-zero in the
    fused sweep); None = the whole batch."""
    iters: int = 50
    adv_lr: float = 2.0
    col_lr: float = 1.0
    adv_w: float = 1.0
    p_thresh: float = 0.9
    camde_range: Optional[tuple] = None


def stealth_weights(stealth_loss: str):
    """Loss name -> (prjl2_w, caml2_w, camdE_w) (ref ``:248-251``)."""
    return (0.1 if "prjl2" in stealth_loss else 0.0,
            1.0 if "caml2" in stealth_loss else 0.0,
            1.0 if "camdE" in stealth_loss else 0.0)


def _per_sample_l2(diff: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel channel L2 norm per sample, [B, H, W, C] -> [B]. The
    1e-12 floor keeps sqrt's gradient finite at exactly-zero differences."""
    s = torch.sum(diff * diff, dim=-1)
    return torch.mean(torch.sqrt(torch.clamp(s, min=1e-12)), dim=(1, 2))


def _normalized(g: torch.Tensor) -> torch.Tensor:
    """g_b / ||g_b||_2 per sample (ref ``:307``)."""
    norms = torch.sqrt(torch.sum(g * g, dim=(1, 2, 3), keepdim=True))
    return g / torch.clamp(norms, min=1e-12)


def _spaa_body(pcnet_apply, logits_fn, cam_scene, state, im_gray,
               target_idx, targeted, weights, d_thr, cfg: SpaaConfig):
    """One SPAA iteration on explicit state
    ``(prj_adv, prj_best, cam_best, col_best)``; returns the next state."""
    b = im_gray.shape[0]
    cam_scene_b = cam_scene.expand(b, *cam_scene.shape[1:])
    prj_adv, prj_best, cam_best, col_best = state
    arange_b = torch.arange(b, device=prj_adv.device)
    tgt_sign = torch.where(targeted, -1.0, 1.0).to(prj_adv.dtype)

    # forward through the frozen simulator; the clamp makes gradients
    # vanish outside [0, 1] (ref :265)
    prj = prj_adv.detach().requires_grad_(True)
    cam_infer = pcnet_apply(torch.clamp(prj, 0.0, 1.0))
    c = cam_infer.detach().requires_grad_(True)

    raw = logits_fn(c)
    with trace.span("spaa.classifier_vjp"):
        adv_raw_cot = torch.zeros_like(raw)
        adv_raw_cot[arange_b, target_idx] = cfg.adv_w * tgt_sign / b
        g_adv_cam, = torch.autograd.grad(raw, c, adv_raw_cot)

    # colour losses through the camera image: caml2 on the whole batch (it
    # also feeds mask_high_pert), camdE only on the camdE-active slice
    with trace.span("spaa.colour"):
        lo, hi = cfg.camde_range if cfg.camde_range is not None else (0, b)
        caml2 = _per_sample_l2(cam_scene_b - c)
        camde = torch.zeros(b, dtype=c.dtype, device=c.device)
        if hi > lo:
            scene_lab = rgb2lab_diff(cam_scene)
            sub_lab = scene_lab.expand(hi - lo, *scene_lab.shape[1:])
            camde_sub = torch.mean(
                ciede2000_diff(rgb2lab_diff(c[lo:hi]), sub_lab), dim=(1, 2))
            camde = torch.cat([camde[:lo], camde_sub, camde[hi:]])
        col_cam_batch = weights[:, 1] * caml2 + weights[:, 2] * camde
        g_col_cam, = torch.autograd.grad(torch.mean(col_cam_batch), c)

        # prjl2 flows directly from prj_adv, not through PCNet
        p2 = prj_adv.detach().requires_grad_(True)
        g_prjl2, = torch.autograd.grad(
            torch.mean(weights[:, 0] * _per_sample_l2(im_gray - p2)), p2)

    with torch.no_grad(), trace.span("spaa.masks"):
        prjl2 = _per_sample_l2(im_gray - prj_adv)
        col_batch = weights[:, 0] * prjl2 + col_cam_batch.detach()
        caml2 = caml2.detach()
        raw = raw.detach()

        # masks (ref :289-299); untargeted ignores the confidence test
        p = torch.softmax(raw, dim=1)
        top_idx = torch.argmax(raw, dim=1)
        top_p = torch.max(p, dim=1).values
        mask_high_conf = top_p > cfg.p_thresh
        mask_high_pert = caml2 * 255.0 > d_thr
        mask_succ = torch.where(targeted, top_idx == target_idx,
                                top_idx != target_idx)
        mask_best_adv = mask_succ & mask_high_pert & (mask_high_conf
                                                      | ~targeted)
        m = mask_best_adv[:, None, None, None]
        cot_cam = torch.where(m, g_col_cam, g_adv_cam)

    # ONE PCNet pullback on the per-sample-selected camera cotangent
    with trace.span("spaa.pcnet_pullback"):
        g_prj, = torch.autograd.grad(cam_infer, prj, cot_cam)

    with torch.no_grad(), trace.span("spaa.update"):
        total = g_prj + torch.where(m, g_prjl2, torch.zeros_like(g_prjl2))
        lr = torch.where(m, cfg.col_lr, cfg.adv_lr).to(total.dtype)
        prj_adv = prj_adv - lr * _normalized(total)

        mask_best = (col_batch < col_best) & mask_best_adv
        col_best = torch.where(mask_best, col_batch, col_best)
        keep = (mask_succ | mask_best)[:, None, None, None]
        prj_best = torch.where(keep, prj_adv, prj_best)
        cam_best = torch.where(keep, cam_infer.detach(), cam_best)
    return prj_adv, prj_best, cam_best, col_best


def spaa_attack_batched(pcnet_apply: Callable, logits_fn: Callable,
                        cam_scene: torch.Tensor, prj_init: torch.Tensor,
                        target_idx: torch.Tensor, targeted: torch.Tensor,
                        weights: torch.Tensor, d_thr: torch.Tensor,
                        cfg: SpaaConfig = SpaaConfig()):
    """The batched SPAA loop. cam_scene [1, H, W, 3]; prj_init
    [B, Hp, Wp, 3]; target_idx [B] int64; targeted [B] bool; weights
    [B, 3] (prjl2, caml2, camdE); d_thr [B]. Returns (cam_infer_best,
    prj_adv_best), NHWC."""
    b = prj_init.shape[0]
    state = (prj_init, prj_init,
             cam_scene.expand(b, *cam_scene.shape[1:]).contiguous(),
             torch.full((b,), 1e6, dtype=prj_init.dtype,
                        device=prj_init.device))
    with trace.span("spaa.sweep", annotate=False):
        for _ in range(cfg.iters):
            with trace.span("spaa.iteration", annotate=False):
                state = _spaa_body(pcnet_apply, logits_fn, cam_scene, state,
                                   prj_init, target_idx, targeted, weights,
                                   d_thr, cfg)
    _, prj_best, cam_best, _ = state
    return cam_best, torch.clamp(prj_best, 0.0, 1.0)


def spaa(pcnet_apply: Callable, logits_fn: Callable, imagenet_labels,
         target_idx, targeted: bool, cam_scene: torch.Tensor, d_thr,
         stealth_loss: str, setup_info, cfg: SpaaConfig = SpaaConfig(),
         verbose: bool = True):
    """Single-config entry (ref ``spaa()``, ``projector_based_attack.py:212``).
    Returns (cam_infer_best, prj_adv_best)."""
    dev, dt = cam_scene.device, cam_scene.dtype
    num = len(target_idx)
    ph, pw = setup_info["prj_im_sz"][1], setup_info["prj_im_sz"][0]
    prj_init = torch.full((num, ph, pw, 3), float(setup_info["prj_brightness"]),
                          dtype=dt, device=dev)
    w = torch.tensor(stealth_weights(stealth_loss), dtype=dt,
                     device=dev).expand(num, 3)
    cam_best, prj_best = spaa_attack_batched(
        pcnet_apply, logits_fn, cam_scene, prj_init,
        torch.as_tensor(list(target_idx), dtype=torch.long, device=dev),
        torch.full((num,), bool(targeted), device=dev), w,
        torch.full((num,), float(d_thr), dtype=dt, device=dev), cfg)
    if verbose:
        with torch.no_grad():
            p = torch.softmax(logits_fn(cam_best), dim=1)
        v = 7 if (targeted and num > 7) else 0
        idx = int(torch.argmax(p[v]))
        print(f"  [spaa done] p = {float(p[v, idx]):.4f} | y = {idx:3d} "
              f"({imagenet_labels.get(idx, '?')})")
    return cam_best, prj_best
