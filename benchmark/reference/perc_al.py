"""Plain PyTorch PerC-AL, projector variant (Zhao et al., CVPR 2020, as the
published SPAA repository adapts it: ``perc_al/__init__.py``
``adversary_projector``), per sample.

From delta = 0 on the camera image, each iteration: where the sample is
not yet a best adversarial (the previous iteration's mask), a step of
``alpha_l`` up the normalised gradient of its cross-entropy (towards the
target when targeted, away from the true class when not); where it is,
a step of ``alpha_c`` down the normalised gradient of its colour distance
(the L2 norm of the CIEDE2000 map against the scene); both step sizes
cosine-annealed (to alpha_l / 100 and alpha_c / 10). Then the image is
clipped to [0, 1] and quantised to 8 bits, and classified: a sample is
adversarial when the target is the top class (targeted) or the true class
trails the best other by ``confidence`` (untargeted); a best adversarial
also has a perturbation (mean per-pixel L2 norm of delta) over d_thr / 255
and, when targeted, a top probability over ``p_thresh``. The quantised
image is kept wherever the sample is adversarial. (The published loop
also keeps the best colour distance among best adversarials, and keeps
the image where the sample is adversarial or beats that best; beating it
needs a best adversarial, which is adversarial, so that bookkeeping
changes no output and is left out.)

:func:`step` returns both candidate steps of one iteration, and
:func:`margins` the decisions as signed margins, so a check can accept
either outcome where a decision is a tie to rounding. :func:`attack` runs
the whole loop (the control runs it in the program's place).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.color import ciede2000, rgb2lab


class Hyper(NamedTuple):
    iters: int = 50
    alpha_l_init: float = 1.0
    alpha_c_init: float = 0.5
    confidence: float = 40.0
    p_thresh: float = 0.9


def step_sizes(i: int, hp: Hyper):
    """(alpha_l, alpha_c) of iteration ``i``."""
    cos = 1.0 + math.cos(i / hp.iters * math.pi)
    lo_l, lo_c = hp.alpha_l_init / 100.0, hp.alpha_c_init / 10.0
    return (lo_l + 0.5 * (hp.alpha_l_init - lo_l) * cos,
            lo_c + 0.5 * (hp.alpha_c_init - lo_c) * cos)


def quantize(x):
    return torch.round(x * 255.0) / 255.0


def normalized(g):
    n = torch.sqrt((g * g).sum(dim=(1, 2, 3), keepdim=True))
    return g / torch.clamp(n, min=1e-12)


def colour_distance(inputs_lab, x):
    """Per sample, the L2 norm of the CIEDE2000 map of x against the
    inputs, [B]."""
    d = ciede2000(inputs_lab, rgb2lab(x))
    return torch.sqrt((d.reshape(d.shape[0], -1) ** 2).sum(1))


def success(raw, labels, targeted, hp: Hyper):
    """The adversarial decision as a signed margin: targeted, the target's
    logit over every other; untargeted, the best other over the true
    class's by ``confidence`` (a margin of exactly 0 counts)."""
    t = raw.gather(1, labels[:, None])[:, 0]
    others = raw.scatter(1, labels[:, None], float("-inf")).max(1).values
    return torch.where(targeted, t - others, others - t - hp.confidence)


def margins(raw, delta, labels, targeted, d_thr, hp: Hyper):
    """The decisions as signed margins (positive = true): adversarial
    (:func:`success`), confidence (top probability minus ``p_thresh``)
    and perturbation (mean per-pixel L2 norm of delta x 255 minus
    d_thr)."""
    succ = success(raw, labels, targeted, hp)
    conf = torch.softmax(raw, 1).max(1).values - hp.p_thresh
    pert = torch.sqrt((delta * delta).sum(-1)).mean(dim=(1, 2)) * 255.0 \
        - d_thr
    return succ, conf, pert


def adversarial(succ, targeted):
    """Untargeted success at a margin of exactly 0 counts (``<=``)."""
    return torch.where(targeted, succ > 0, succ >= 0)


def best_adv(succ, conf, pert, targeted):
    return adversarial(succ, targeted) & (pert > 0) & ((conf > 0)
                                                       | ~targeted)


def step(logits_fn, inputs, inputs_lab, delta, labels, targeted, i: int,
         hp: Hyper):
    """One iteration's two candidate steps from ``delta`` (a sample takes
    the first where it is not a best adversarial, the second where it
    is), each clipped: ``(next_adv, next_col)``."""
    alpha_l, alpha_c = step_sizes(i, hp)
    sign = torch.where(targeted, -1.0, 1.0).to(inputs.dtype)
    d = delta.detach().requires_grad_(True)
    logp = torch.log_softmax(logits_fn(inputs + d), dim=1)
    g_adv, = torch.autograd.grad(
        (sign * -logp.gather(1, labels[:, None])[:, 0]).sum(), d)
    d = delta.detach().requires_grad_(True)
    g_col, = torch.autograd.grad(
        colour_distance(inputs_lab, inputs + d).sum(), d)
    with torch.no_grad():
        nxt = (delta + alpha_l * normalized(g_adv),
               delta - alpha_c * normalized(g_col))
        return tuple(torch.clamp(inputs + n, 0.0, 1.0) - inputs for n in nxt)


def attack(logits_fn, inputs, labels, targeted, d_thr, hp: Hyper):
    """The whole loop on a batch; returns the kept quantised images."""
    with torch.no_grad():
        inputs_lab = rgb2lab(inputs)
    delta = torch.zeros_like(inputs)
    m = torch.zeros(inputs.shape[0], dtype=torch.bool, device=inputs.device)
    x_best = inputs
    for i in range(hp.iters):
        nxt_adv, nxt_col = step(logits_fn, inputs, inputs_lab, delta, labels,
                                targeted, i, hp)
        with torch.no_grad():
            delta = torch.where(m[:, None, None, None], nxt_col, nxt_adv)
            x_round = quantize(inputs + delta)
            succ, conf, pert = margins(logits_fn(x_round), delta, labels,
                                       targeted, d_thr, hp)
            m = best_adv(succ, conf, pert, targeted)
            keep = adversarial(succ, targeted)[:, None, None, None]
            x_best = torch.where(keep, x_round, x_best)
    return x_best
