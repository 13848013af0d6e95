"""PerC-AL: alternating classification / colour-difference adversarial
attack (counterpart of ``spaa_tpu/attack/perc_al.py``, reference
``perc_al/__init__.py``, Zhao et al. CVPR'20 as extended for SPAA).

Both the digital ``adversary`` and the projector variant
``adversary_projector`` run :func:`perc_al_core`: a Python loop over
iterations on explicit state ``(delta, mask_adv, col_best, x_best)``,
NHWC images in [0, 1]. What differs from SPAA's loop (ref lines inline):
  - cross-entropy (not raw-score) adversarial loss (``:97,186``);
  - the colour distance is the L2 norm of the CIEDE2000 map per sample
    (``:104``), not its mean;
  - the adversarial image is quantised to 8 bits every iteration
    (``:15-18,114,212``);
  - cosine-annealed step sizes, alpha_l init -> init/100 and alpha_c
    init -> init/10 (``:75-76,94-96``), computed in float32 as
    ``spaa_tpu`` computes them.
The batch may mix targeted and untargeted samples (``targeted`` per
sample); the confidence margin applies to untargeted samples only.
``logits_fn(im) -> raw logits`` is a differentiable closure over a frozen
classifier (``attack.orchestrate.make_attack_logits_fn``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from spaa_tpu_torch.ops.color import ciede2000_diff, rgb2lab_diff


def quantization(x: torch.Tensor) -> torch.Tensor:
    """8-bit quantisation, half to even (ref ``perc_al/__init__.py:15-18``)."""
    return torch.round(x * 255.0) / 255.0


def _normalized(g: torch.Tensor) -> torch.Tensor:
    """g_b / ||g_b||_2 per sample."""
    n = torch.sqrt(torch.sum(g * g, dim=(1, 2, 3), keepdim=True))
    return g / torch.clamp(n, min=1e-12)


class PercALConfig(NamedTuple):
    max_iterations: int = 1000
    alpha_l_init: float = 1.0
    alpha_c_init: float = 0.5
    confidence: float = 0.0
    p_thresh: float = 0.9   # projector variant only (ref :159)


def _step_sizes(i: int, cfg: PercALConfig):
    """(alpha_l, alpha_c) of iteration ``i``: the cosine schedule in
    float32 (``spaa_tpu`` casts the iteration to float32), as Python
    floats holding the float32 values."""
    f = np.float32
    cos = f(1.0) + np.cos(f(i) / f(cfg.max_iterations) * f(math.pi),
                          dtype=f)
    alpha_l_min = cfg.alpha_l_init / 100.0
    alpha_c_min = cfg.alpha_c_init / 10.0
    alpha_l = f(alpha_l_min) + f(0.5 * (cfg.alpha_l_init - alpha_l_min)) * cos
    alpha_c = f(alpha_c_min) + f(0.5 * (cfg.alpha_c_init - alpha_c_min)) * cos
    return float(alpha_l), float(alpha_c)


def _percal_body(logits_fn: Callable, inputs, inputs_lab, labels, targeted,
                 cfg: PercALConfig, d_thr, projector_variant: bool, i: int,
                 state):
    """One PerC-AL iteration (ref ``perc_al/__init__.py:93-131,153-245``):
    a cross-entropy step where the sample is not yet a best adversarial,
    a colour step where it is (``mask_adv`` is the previous iteration's
    ``mask_best_adv``), clip, quantise, then the masked best tracking.
    Returns the next state."""
    b = inputs.shape[0]
    arange_b = torch.arange(b, device=inputs.device)
    multiplier = torch.where(targeted, -1.0, 1.0).to(inputs.dtype)
    alpha_l, alpha_c = _step_sizes(i, cfg)
    delta, mask_adv, col_best, x_best = state
    m = mask_adv[:, None, None, None]

    d = delta.detach().requires_grad_(True)
    logp = torch.log_softmax(logits_fn(inputs + d), dim=1)
    grad_a, = torch.autograd.grad(
        torch.sum(multiplier * -logp[arange_b, labels]), d)
    delta = torch.where(m, delta, delta + alpha_l * _normalized(grad_a))

    # no epsilon under the norm: its gradient at an all-zero map is NaN, as
    # in spaa_tpu, and the where below drops it the same way
    d = delta.detach().requires_grad_(True)
    dmap = ciede2000_diff(inputs_lab, rgb2lab_diff(inputs + d))
    color_dis = torch.sqrt(torch.sum(dmap.reshape(b, -1) ** 2, dim=1))
    grad_c, = torch.autograd.grad(torch.sum(color_dis), d)
    delta = torch.where(m, delta - alpha_c * _normalized(grad_c), delta)

    with torch.no_grad():
        color_dis = color_dis.detach()
        delta = torch.clamp(inputs + delta, 0.0, 1.0) - inputs
        x_round = quantization(inputs + delta)
        raw = logits_fn(x_round)
        top_p = torch.softmax(raw, dim=1).max(dim=1).values
        top_idx = torch.argmax(raw, dim=1)
        if cfg.confidence != 0:
            real = raw[arange_b, labels]
            masked = raw.clone()
            masked[arange_b, labels] = -math.inf
            isadv_untargeted = (real - masked.max(dim=1).values
                                <= -cfg.confidence)
        else:
            isadv_untargeted = top_idx != labels
        mask_isadv = torch.where(targeted, top_idx == labels,
                                 isadv_untargeted)
        if projector_variant:
            # ref :214-238: the perturbation must also be large enough, and
            # a targeted sample confident enough
            caml2 = torch.mean(torch.sqrt(torch.sum(delta * delta, dim=-1)),
                               dim=(1, 2))
            mask_best_adv = (mask_isadv & (caml2 * 255.0 > d_thr)
                             & ((top_p > cfg.p_thresh) | ~targeted))
        else:
            mask_best_adv = mask_isadv
        mask_best = (color_dis < col_best) & mask_best_adv
        col_best = torch.where(mask_best, color_dis, col_best)
        keep = (mask_isadv | mask_best) if projector_variant else mask_best
        x_best = torch.where(keep[:, None, None, None], x_round, x_best)
    return delta, mask_best_adv, col_best, x_best


def _as_targeted(targeted, b: int, device) -> torch.Tensor:
    """A Python bool (uniform batch) or a per-sample [B] bool array."""
    if isinstance(targeted, (bool, np.bool_)):
        return torch.full((b,), bool(targeted), device=device)
    return torch.as_tensor(targeted, dtype=torch.bool, device=device)


def perc_al_core(logits_fn: Callable, inputs: torch.Tensor,
                 labels: torch.Tensor, targeted, cfg: PercALConfig,
                 d_thr: Optional[torch.Tensor] = None,
                 projector_variant: bool = False) -> torch.Tensor:
    """The PerC-AL loop shared by ``adversary`` (``projector_variant``
    False) and ``adversary_projector`` (True): ``cfg.max_iterations``
    iterations from delta = 0. inputs [B, H, W, 3] in [0, 1]; labels [B]
    int64; ``targeted`` a bool or [B] bools; d_thr [B] (projector variant).
    Returns the best quantised adversarial images [B, H, W, 3]."""
    b = inputs.shape[0]
    inputs = inputs.contiguous()
    targeted = _as_targeted(targeted, b, inputs.device)
    with torch.no_grad():
        inputs_lab = rgb2lab_diff(inputs)
    state = (torch.zeros_like(inputs),
             torch.zeros((b,), dtype=torch.bool, device=inputs.device),
             torch.full((b,), 1e5, dtype=inputs.dtype, device=inputs.device),
             inputs)
    for i in range(cfg.max_iterations):
        state = _percal_body(logits_fn, inputs, inputs_lab, labels, targeted,
                             cfg, d_thr, projector_variant, i, state)
    return state[3]


def _check_range(inputs: torch.Tensor) -> None:
    if float(inputs.min()) < 0 or float(inputs.max()) > 1:
        raise ValueError("Input values should be in the [0, 1] range.")


class PerC_AL:
    """Class-shaped API of reference ``perc_al.PerC_AL`` (``:21-51``)."""

    def __init__(self, max_iterations: int = 1000, alpha_l_init: float = 1.0,
                 alpha_c_init: float = 0.5, confidence: float = 0.0):
        self.cfg = PercALConfig(max_iterations, alpha_l_init, alpha_c_init,
                                confidence)

    def adversary(self, logits_fn: Callable, inputs: torch.Tensor, labels,
                  targeted=True) -> torch.Tensor:
        """Digital PerC-AL (ref ``:53-131``); ``logits_fn`` includes the
        model's own preprocessing, inputs in [0, 1]."""
        _check_range(inputs)
        return perc_al_core(logits_fn, inputs, torch.as_tensor(
            np.asarray(labels), dtype=torch.long, device=inputs.device),
            targeted, self.cfg)

    def adversary_projector(self, logits_fn: Callable, inputs: torch.Tensor,
                            labels, imagenet_labels=None, d_thr=5.0,
                            targeted=True, verbose: bool = True):
        """The projector-adapted variant (ref ``:133-256``): ``logits_fn``
        already crops to the classifier's crop size; ``targeted`` a bool or
        per-sample bools (the fused targeted + untargeted batch)."""
        _check_range(inputs)
        b = inputs.shape[0]
        x_best = perc_al_core(
            logits_fn, inputs,
            torch.as_tensor(np.asarray(labels), dtype=torch.long,
                            device=inputs.device),
            targeted, self.cfg,
            d_thr=torch.full((b,), float(d_thr), dtype=inputs.dtype,
                             device=inputs.device),
            projector_variant=True)
        if verbose and imagenet_labels is not None:
            with torch.no_grad():
                p = torch.softmax(logits_fn(x_best), dim=1)
            any_targeted = bool(_as_targeted(targeted, b, x_best.device).any())
            v = 7 if (any_targeted and b > 7) else 0
            idx = int(torch.argmax(p[v]))
            print(f"  [perc_al done] p = {float(p[v, idx]):.4f} | y = {idx} "
                  f"({imagenet_labels.get(idx, '?')})")
        return x_best
