"""One-pixel differential-evolution attackers (counterpart of
``spaa_tpu/attack/one_pixel.py``, reference
``one_pixel_attacker/__init__.py``).

  - ``BatchedDE``: best1bin differential evolution whose whole population
    is scored by one fitness call per generation (deferred updates, the
    reference's dead batched solver made live), numpy as in ``spaa_tpu``;
  - ``DigitalOnePixelAttacker``: the hardware-free attack (ref ``:47-121``):
    the population is perturbed and classified as one batch on the
    classifier's device;
  - ``ProjectorOnePixelAttacker``: the project-and-capture attack (ref
    ``:124-245``): captures are serial, each generation's captures are
    classified as one batch.

SciPy-default knobs the reference relies on: recombination 1, mutation
dithered U(0.5, 1) per generation, best1bin, no polish, early stop on
attack success.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from spaa_tpu_torch.ops.image import center_crop
from spaa_tpu_torch.utils.table import Table

RESULT_COLUMNS = ["classifier", "pixel_count", "true_idx", "pred_idx",
                  "success", "true_p", "pred_p", "cdiff"]


def perturb_image_np(x: np.ndarray, im: np.ndarray,
                     pixel_size: int) -> np.ndarray:
    """Apply [x, y, r, g, b] * k block perturbations to an HWC float image
    (ref ``perturb_image``, ``one_pixel_attacker/__init__.py:18-44``; x is
    the row, y the column). Every value is truncated, the colour included,
    and a block is cut at the image border."""
    im_adv = (im * 255).astype(np.uint8).copy()
    d = pixel_size // 2
    x = x.astype(int)
    for pixel in np.split(x, len(x) // 5):
        r, c, *rgb = pixel
        im_adv[max(r - d, 0):r + d + 1, max(c - d, 0):c + d + 1] = rgb
    return im_adv.astype(np.float32) / 255.0


def _make_batched_perturb(pixel_size: int):
    """``perturb(im [H, W, C], pop [P, 5k]) -> [P, H, W, C]`` on ``im``'s
    device. As ``spaa_tpu``'s ``dynamic_update_slice`` write: the
    population is cast to float32 first, the colour rounded half to even
    and the row and column truncated; a block's start is clamped so that
    the whole block stays inside the image."""
    d = pixel_size // 2
    sz = 2 * d + 1

    def perturb(im: torch.Tensor, pop) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(pop), device=im.device).to(
            torch.float32)
        h, w = im.shape[0], im.shape[1]
        rows = torch.arange(h, device=im.device)
        cols = torch.arange(w, device=im.device)
        imgs = im.expand(x.shape[0], *im.shape)
        for j in range(x.shape[1] // 5):
            r0 = (x[:, 5 * j].to(torch.int64) - d).clamp(0, max(h - sz, 0))
            c0 = (x[:, 5 * j + 1].to(torch.int64) - d).clamp(0, max(w - sz, 0))
            rgb = torch.round(x[:, 5 * j + 2:5 * j + 5]).to(im.dtype) / 255.0
            in_r = (rows >= r0[:, None]) & (rows < r0[:, None] + sz)
            in_c = (cols >= c0[:, None]) & (cols < c0[:, None] + sz)
            block = in_r[:, :, None, None] & in_c[:, None, :, None]
            imgs = torch.where(block, rgb[:, None, None, :], imgs)
        return imgs

    return perturb


class BatchedDE:
    """best1bin DE with whole-population batched fitness.

    fitness_fn: [P, D] population -> [P] costs (lower is better). The
    reference's dead solver passed the population matrix to ``func`` for
    exactly this purpose (``differential_evolution.py:692-708``).
    """

    def __init__(self, fitness_fn: Callable, bounds, popsize: int,
                 maxiter: int, recombination: float = 1.0,
                 mutation=(0.5, 1.0), seed: int = 0,
                 callback: Optional[Callable] = None):
        self.fitness_fn = fitness_fn
        self.bounds = np.asarray(bounds, np.float64)
        self.popsize = popsize
        self.maxiter = maxiter
        self.recombination = recombination
        self.mutation = mutation
        self.rng = np.random.default_rng(seed)
        self.callback = callback

    def _init_population(self, dim: int) -> np.ndarray:
        """Latin-hypercube init, scipy-style."""
        p = self.popsize
        segsize = 1.0 / p
        samples = (segsize * self.rng.random((p, dim))
                   + np.linspace(0.0, 1.0, p, endpoint=False)[:, None])
        for j in range(dim):
            self.rng.shuffle(samples[:, j])
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + samples * (hi - lo)

    def solve(self):
        dim = len(self.bounds)
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        pop = self._init_population(dim)
        energies = np.array(self.fitness_fn(pop), copy=True)
        best_i = int(np.argmin(energies))

        for gen in range(self.maxiter):
            f = self.rng.uniform(*self.mutation)  # dithering per generation
            best = pop[best_i]
            idx = np.arange(self.popsize)
            r1 = np.array([self.rng.choice(np.delete(idx, i)) for i in idx])
            r2 = np.array([self.rng.choice(np.delete(idx, [i, r1[i]]))
                           for i in idx])
            mutants = best + f * (pop[r1] - pop[r2])
            # binomial crossover (recombination=1 -> mutant everywhere)
            cross = self.rng.random((self.popsize, dim)) < self.recombination
            force = self.rng.integers(0, dim, self.popsize)
            cross[idx, force] = True
            trials = np.where(cross, mutants, pop)
            # out-of-bounds components are resampled uniformly, as scipy's
            # ``_ensure_constraint`` does: clipping piles trials onto the
            # bounds and hurts convergence
            oob = (trials < lo) | (trials > hi)
            if oob.any():
                trials[oob] = (lo + self.rng.random(
                    (self.popsize, dim)) * (hi - lo))[oob]

            trial_energies = np.asarray(self.fitness_fn(trials))
            improved = trial_energies < energies
            pop[improved] = trials[improved]
            energies[improved] = trial_energies[improved]
            best_i = int(np.argmin(energies))

            if self.callback is not None and self.callback(pop[best_i]):
                break
        return pop[best_i], energies[best_i]


def _bounds(h: int, w: int, pixel_size: int, pixel_count: int, popsize: int):
    """DE bounds of ``pixel_count`` blocks and the population size:
    ``popsize // 5k`` per dimension, as scipy's ``popsize`` multiplier."""
    d = pixel_size // 2
    bounds = [(d, h - 1 - d), (d, w - 1 - d),
              (0, 255), (0, 255), (0, 255)] * pixel_count
    return bounds, max(1, popsize // len(bounds)) * len(bounds)


def _key(x) -> bytes:
    return np.asarray(x, np.float64).tobytes()


def _result_table(name, pixel_count, pp, targeted_attack, target_idx):
    """The one-row result table of both attackers (ref ``:105-113``):
    ``pp`` holds the clean image's and the adversarial image's softmax."""
    true_p, pred_p = pp[0].max(), pp[1].max()
    true_idx, pred_idx = int(pp[0].argmax()), int(pp[1].argmax())
    success = (pred_idx == target_idx) if targeted_attack \
        else (pred_idx != true_idx)
    cdiff = pp[0, target_idx] - pp[1, target_idx]
    return Table(RESULT_COLUMNS, [[name, pixel_count, true_idx, pred_idx,
                                   bool(success), float(true_p),
                                   float(pred_p), float(cdiff)]])


def _softmax_np(raw: torch.Tensor) -> np.ndarray:
    return torch.softmax(raw, dim=1).cpu().numpy()


class DigitalOnePixelAttacker:
    """Hardware-free one-pixel attack; the DE population is perturbed and
    classified as one batch per generation on the classifier's device
    (``classifier.device``, ``classifier.logits(imgs, crop_sz)``).
    ``cache_misses`` counts candidates the callback found no prediction
    for (each costs one extra classification)."""

    def __init__(self, class_names, classifier_crop_sz):
        self.class_names = class_names
        self.classifier_crop_sz = tuple(int(c) for c in classifier_crop_sz)
        self.cache_misses = 0

    def attack(self, im, classifier, targeted_attack=False, target_idx=None,
               pixel_count=1, pixel_size=1, maxiter=75, popsize=400,
               verbose=False, true_label=None, seed: int = 0):
        im = torch.as_tensor(im, device=classifier.device)
        if im.ndim == 4:
            im = im[0]
        bounds, npop = _bounds(im.shape[0], im.shape[1], pixel_size,
                               pixel_count, popsize)
        perturb = _make_batched_perturb(pixel_size)
        crop_sz = self.classifier_crop_sz
        pred_cache: dict = {}

        def fitness(pop):
            with torch.no_grad():
                p = torch.softmax(classifier.logits(perturb(im, pop),
                                                    crop_sz), dim=1)
                probs = p[:, target_idx].cpu().numpy()
                preds = p.argmax(dim=1).cpu().numpy()
                pmaxs = p.amax(dim=1).cpu().numpy()
            for x, pr, pm in zip(pop, preds, pmaxs):
                pred_cache[_key(x)] = (int(pr), float(pm))
            return (1.0 - probs) if targeted_attack else probs

        def callback(best_x):
            hit = pred_cache.get(_key(best_x))
            if hit is None:   # defensive fallback: one extra classify
                self.cache_misses += 1
                raw, _, _ = classifier(perturb(im, best_x[None])[0], crop_sz)
                pp = _softmax_np(raw)
                hit = (int(pp[0].argmax()), float(pp[0].max()))
            pred, pmax = hit
            if verbose:
                tag = (f"Target: {self.class_names[target_idx]:<20} "
                       if targeted_attack else "Untargeted | ")
                print(f"{tag}Pred: {self.class_names[pred]:<20} "
                      f"({pmax:.2f})")
            return ((targeted_attack and pred == target_idx)
                    or (not targeted_attack and pred != target_idx))

        de = BatchedDE(fitness, bounds, popsize=npop, maxiter=maxiter,
                       recombination=1.0, seed=seed, callback=callback)
        best_x, _ = de.solve()

        im_adv = perturb(im, best_x[None])[0]
        raw, _, _ = classifier(torch.stack([im, im_adv], 0), crop_sz)
        table = _result_table(classifier.name, pixel_count, _softmax_np(raw),
                              targeted_attack, target_idx)
        return table, im_adv

    __call__ = attack


class ProjectorOnePixelAttacker:
    """Project-and-capture one-pixel DE (ref
    ``one_pixel_attacker/__init__.py:124-245``): each candidate is
    projected and captured in turn, then the generation's captures are
    classified as one batch.

    ``procams`` is any object with ``capture(prj_im) -> cam_im`` on HWC
    float numpy arrays (``utils.sim_procams.SimProCams``). ``im_cam_org``,
    the clean capture (HWC numpy), is what the final classification holds
    the adversarial capture against. ``cache_misses`` counts candidates
    the callback found no prediction for (each costs one more capture)."""

    def __init__(self, class_names, setup_info, procams):
        self.class_names = class_names
        self.setup_info = setup_info
        self.cp_sz = tuple(int(c) for c in setup_info["classifier_crop_sz"])
        self.procams = procams
        self.im_cam_org = None
        self.cache_misses = 0

    def perturb_project_capture(self, x, im, pixel_size):
        im_prj_adv = perturb_image_np(np.asarray(x), np.asarray(im),
                                      pixel_size)
        im_cam_adv = self.procams.capture(im_prj_adv)
        return im_prj_adv, im_cam_adv

    def attack(self, im, classifier, targeted_attack=False, target_idx=None,
               pixel_count=1, pixel_size=1, maxiter=75, popsize=400,
               verbose=False, true_label=None, seed: int = 0):
        im = np.asarray(im)
        if im.ndim == 4:
            im = im[0]
        bounds, npop = _bounds(im.shape[0], im.shape[1], pixel_size,
                               pixel_count, popsize)
        # every candidate's full prediction is known from its generation's
        # batched classification: cached, the callback needs no second
        # projection and capture (under camera noise the cached prediction
        # is the one that scored)
        pred_cache: dict = {}

        def fitness(pop):
            cams = np.stack(
                [self.perturb_project_capture(x, im, pixel_size)[1]
                 for x in pop], 0)
            raw, _, _ = classifier(cams, self.cp_sz)
            pp = _softmax_np(raw)
            for x, row in zip(pop, pp):
                pred_cache[_key(x)] = row
            return (1.0 - pp[:, target_idx]) if targeted_attack \
                else pp[:, target_idx]

        def callback(best_x):
            row = pred_cache.get(_key(best_x))
            if row is None:   # not seen by fitness (defensive): capture
                self.cache_misses += 1
                _, cam = self.perturb_project_capture(best_x, im, pixel_size)
                raw, _, _ = classifier(cam, self.cp_sz)
                row = _softmax_np(raw)[0]
            pred = int(row.argmax())
            if verbose:
                tag = (f"Target: {self.class_names[target_idx]:<20} "
                       f"({row[target_idx]:.2f}) | "
                       if targeted_attack else "Untargeted | ")
                print(f"{tag}Pred: {self.class_names[pred]:<20} "
                      f"({row.max():.2f}) | GT: {str(true_label):<15}")
            return ((targeted_attack and pred == target_idx)
                    or (not targeted_attack and pred != target_idx))

        de = BatchedDE(fitness, bounds, popsize=npop, maxiter=maxiter,
                       recombination=1.0, seed=seed, callback=callback)
        best_x, _ = de.solve()

        im_prj_adv, im_cam_adv = self.perturb_project_capture(
            best_x, im, pixel_size)
        org = self.im_cam_org if self.im_cam_org is not None else im_cam_adv
        both = center_crop(torch.from_numpy(np.stack([org, im_cam_adv], 0)),
                           self.cp_sz)
        raw, _, _ = classifier(both, self.cp_sz)
        table = _result_table(classifier.name, pixel_count, _softmax_np(raw),
                              targeted_attack, target_idx)
        return table, im_prj_adv, im_cam_adv

    __call__ = attack
