"""Training runtime for PCNet and CompenNet++ (counterpart of
``spaa_tpu/train/train.py``, reference ``train_network.py``).

  - the loss menu l1/l2/ssim/huber with the l1 -> l1+ssim curriculum
    weight (``compute_loss``);
  - three Adam groups with their own learning rates and milestones, and
    torch Adam's coupled weight decay on the shading group only
    (``make_pcnet_optimizer``); one Adam with a StepLR for CompenNet and
    CompenNet++ (``make_compennet_pp_optimizer``);
  - the minibatch plan drawn up front with Python's ``random.sample``, as
    the reference draws it, so both packages take the same minibatches;
  - ``train_model``: one step per iteration over uint8 train tensors that
    stay on the device (cast after the gather), a report every
    ``valid_rate`` iterations with validation and a resume snapshot;
  - ``make_evaluator``: chunked no-grad validation.
"""

from __future__ import annotations

import math
import os
import random
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from spaa_tpu_torch.ops import metrics as M
from spaa_tpu_torch.ops.ssim import ssim as ssim_fn
from spaa_tpu_torch.utils import log as L
from spaa_tpu_torch.utils.config import DictConfig


def _pseudo_huber(x, y, scaling: float = 0.1):
    d2 = (x - y) ** 2
    h = (torch.sqrt(torch.clamp(1 + d2 / scaling ** 2, min=1e-4)) - 1) * scaling
    return torch.mean(h.abs())


def compute_loss(infer: torch.Tensor, target: torch.Tensor, loss_option: str,
                 ssim_weight: Optional[float] = None):
    """Loss menu l1/l2/ssim/huber (ref ``train_network.py:367-392``); the
    SSIM term is scaled by ``ssim_weight`` when given (the curriculum) and
    left out at weight 0. Returns (train_loss, l2_loss)."""
    if not loss_option:
        raise TypeError("Loss type not specified")
    train_loss = 0.0
    l2_loss = torch.mean((infer - target) ** 2)
    if "l1" in loss_option:
        train_loss = train_loss + torch.mean((infer - target).abs())
    if "l2" in loss_option:
        train_loss = train_loss + l2_loss
    if "ssim" in loss_option and ssim_weight != 0:
        s = 1.0 - ssim_fn(infer, target)
        train_loss = train_loss + (s if ssim_weight is None
                                   else ssim_weight * s)
    if "huber" in loss_option:
        train_loss = train_loss + _pseudo_huber(infer, target)
    return train_loss, l2_loss


def get_model_train_cfg(model_list, data_root=None, setup_list=None,
                        device_ids=(0,), center_crop=False,
                        load_pretrained=False, plot_on=False,
                        single=False) -> DictConfig:
    """Training config factory (ref ``train_network.py:444-473``); defaults
    kept identical so config-derived names match the reference layout."""
    cfg = DictConfig({})
    cfg.data_root = data_root
    cfg.setup_list = setup_list
    cfg.device = "cuda"
    cfg.device_ids = list(device_ids)
    cfg.load_pretrained = load_pretrained
    cfg.max_iters = 2000
    cfg.batch_size = 24
    cfg.lr = 1e-3
    cfg.lr_drop_ratio = 0.2
    cfg.lr_drop_rate = 800
    cfg.l2_reg = 1e-4
    cfg.train_plot_rate = 50
    cfg.valid_rate = 200
    cfg.plot_on = plot_on
    cfg.center_crop = center_crop
    if single:
        cfg.model_name = model_list[0]
        cfg.num_train = 500
        cfg.loss = "l1+ssim"
    else:
        cfg.model_list = model_list
        cfg.num_train_list = [500]
        cfg.loss_list = ["l1+ssim"]
    return cfg


# PCNet's groups: (name, learning rate, milestone); ref
# ``train_network.py:252-265``
PCNET_GROUPS = (("aff_tps", 1e-2, 100), ("refine", 5e-3, 1200),
                ("shading", 1e-3, 1800))


def _pcnet_group(name: str) -> str:
    if name.startswith("warping_net."):
        return "aff_tps" if name.split(".")[-1] in ("affine_mat", "theta") \
            else "refine"
    return "shading"


def make_pcnet_optimizer(model: torch.nn.Module, cfg):
    """Adam over PCNet's three groups (affine + TPS theta, grid refiner,
    shading) at lrs 1e-2 / 5e-3 / 1e-3, each scaled by ``lr_drop_ratio``
    from its own milestone on (100 / 1200 / 1800: the update counted from
    0 as ``k`` uses the dropped lr once ``k >= milestone``, as optax's
    ``piecewise_constant_schedule``), weight decay ``l2_reg`` on the
    shading group only. Returns ``(optimizer, scheduler)``; call
    ``scheduler.step()`` after every ``optimizer.step()``."""
    params = {g: [] for g, _, _ in PCNET_GROUPS}
    for name, p in model.named_parameters():
        params[_pcnet_group(name)].append(p)
    groups = [dict(params=params[g], lr=lr,
                   weight_decay=cfg.l2_reg if g == "shading" else 0.0)
              for g, lr, _ in PCNET_GROUPS]
    opt = torch.optim.Adam(groups)
    gamma = float(cfg.lr_drop_ratio)
    lambdas = [lambda k, m=m: gamma if k >= m else 1.0
               for _, _, m in PCNET_GROUPS]
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambdas)


def make_compennet_pp_optimizer(model: torch.nn.Module, cfg):
    """One Adam over ALL parameters (affine and TPS theta included) at
    ``cfg.lr`` with weight decay ``l2_reg``, scaled by ``lr_drop_ratio`` at
    every multiple of ``lr_drop_rate`` up to ``max_iters`` (a StepLR, ref
    ``train_network.py:145-148``; the update counted from 0 as ``k`` takes
    one more drop at each boundary ``b <= k``, as optax's
    ``piecewise_constant_schedule``). Returns ``(optimizer, scheduler)``."""
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                           weight_decay=cfg.l2_reg)
    gamma = float(cfg.lr_drop_ratio)
    rate = int(cfg.lr_drop_rate)
    bounds = range(rate, int(cfg.max_iters) + 1, rate)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: gamma ** sum(k >= b for b in bounds))


def sample_batch_indices(num_train: int, batch_size: int, max_iters: int,
                         seed_state: Optional[random.Random] = None):
    """All minibatch indices up front [max_iters, batch_size] int32, drawn
    with Python's ``random.sample`` like the reference
    (``train_network.py:295``)."""
    r = seed_state or random
    return np.asarray([r.sample(range(num_train), batch_size)
                       for _ in range(max_iters)], np.int32)


def _data_fingerprint(train_arrays: dict, batch_idx: np.ndarray) -> int:
    """CRC32 of the training data's shapes and types, a few strided
    images and the whole index plan: a resume snapshot written for other
    data (a re-captured setup under the same config string) is detected."""
    h = 0
    for key in ("inputs", "targets"):
        a = np.asarray(train_arrays[key])
        h = zlib.crc32(f"{a.shape}{a.dtype}".encode(), h)
        step = max(1, a.shape[0] // 4)
        h = zlib.crc32(np.ascontiguousarray(a[::step]).tobytes(), h)
    return zlib.crc32(np.asarray(batch_idx).tobytes(), h)


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


def train_model(loss_fn: Callable, model: torch.nn.Module, optimizer,
                scheduler, train_arrays: dict, batch_idx: np.ndarray, cfg,
                device, valid_fn: Optional[Callable] = None,
                log_prefix: str = "", curve_logger=None,
                resume_path: Optional[str] = None,
                step_losses: Optional[list] = None):
    """Train ``model`` for ``cfg.max_iters`` iterations, one optimizer step
    each: ``loss_fn(inputs, targets, itr) -> (loss, l2)``. ``scheduler``
    may be None (a constant learning rate).

    train_arrays: host arrays 'inputs' [N, ...] and 'targets' [N, ...]
    (uint8, or float in [0, 1]); they move to ``device`` once and each
    minibatch is cast to float after its gather. Every ``cfg.valid_rate``
    iterations (and at the end) the loop validates, prints, logs the
    curve and writes the resume snapshot.

    ``resume_path``: if a snapshot for the same data and index plan exists,
    training continues from its iteration with its Adam moments (the
    remaining minibatches are the ones the killed run would have drawn);
    one for other data, or not of this package's layout, is discarded.
    Removed on completion.

    ``step_losses``: if given, every iteration's ``(loss, l2)`` is appended
    to it as a float pair, read from the device once a segment.
    Returns (valid_psnr, valid_rmse, valid_ssim)."""
    start_it = 0
    data_fp = 0
    if resume_path is not None:
        data_fp = _data_fingerprint(train_arrays, batch_idx)
        if os.path.exists(resume_path):
            try:
                model_sd, opt_state, it2, fp2 = L.load_train_state(
                    resume_path)
            except ValueError as e:
                fp2 = None
                print(f"{log_prefix}WARNING: {e}; discarding it")
            if fp2 == data_fp:
                model.load_state_dict(model_sd)
                sd = optimizer.state_dict()
                sd["state"] = opt_state
                optimizer.load_state_dict(sd)
                start_it = it2
                print(f"{log_prefix}Resuming from {resume_path} at iter "
                      f"{start_it}")
            else:
                if fp2 is not None:
                    print(f"{log_prefix}WARNING: {resume_path} was written "
                          "for DIFFERENT training data or index plan - "
                          "discarding the stale snapshot and training from "
                          "scratch")
                os.remove(resume_path)
    if scheduler is not None:
        for g, f in zip(optimizer.param_groups, scheduler.lr_lambdas):
            g["lr"] = g["initial_lr"] * f(start_it)
        scheduler.last_epoch = start_it

    inputs = torch.as_tensor(train_arrays["inputs"]).to(device)
    targets = torch.as_tensor(train_arrays["targets"]).to(device)
    idx_all = torch.as_tensor(np.asarray(batch_idx, np.int64)).to(device)
    dtype = next(model.parameters()).dtype
    max_iters, seg = int(cfg.max_iters), int(cfg.valid_rate)
    start = time.time()
    valid_psnr = valid_rmse = valid_ssim = 0.0
    it = start_it
    model.train()
    while it < max_iters:
        seg_losses = []
        for j in range(it, min(it + seg, max_iters)):
            x = _to_unit(inputs.index_select(0, idx_all[j])).to(dtype)
            y = _to_unit(targets.index_select(0, idx_all[j])).to(dtype)
            loss, l2 = loss_fn(x, y, j)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            if step_losses is not None:
                seg_losses.append(torch.stack([loss.detach(), l2.detach()]))
        if step_losses is not None:
            step_losses.extend(torch.stack(seg_losses).tolist())
        it = min(it + seg, max_iters)
        if resume_path is not None:
            L.save_train_state(resume_path, model, optimizer, it, data_fp)
        if valid_fn is not None:
            valid_psnr, valid_rmse, valid_ssim, _ = valid_fn()
        loss_v = loss.item()
        rmse_v = math.sqrt(l2.item() * 3)
        lapse = time.strftime("%H:%M:%S", time.gmtime(time.time() - start))
        print(f"{log_prefix}Iter:{it:5d} | Time: {lapse} | "
              f"Train Loss: {loss_v:.4f} | Train RMSE: {rmse_v:.4f} | "
              f"Valid PSNR: {valid_psnr:2.4f} | Valid RMSE: {valid_rmse:.4f} "
              f"| Valid SSIM: {valid_ssim:.4f} |")
        if curve_logger is not None:
            curve_logger.append(it, train_loss=loss_v, train_rmse=rmse_v,
                                valid_psnr=valid_psnr, valid_rmse=valid_rmse,
                                valid_ssim=valid_ssim)
    model.eval()
    if resume_path is not None and os.path.exists(resume_path):
        os.remove(resume_path)     # completed: the checkpoint supersedes it
    return valid_psnr, valid_rmse, valid_ssim


def make_evaluator(apply_fn: Callable, valid_inputs, valid_targets, device,
                   chunk_sz: int = 10):
    """Chunked no-grad validation (ref ``evaluate_model``,
    ``train_network.py:395-441``): ``apply_fn(x) -> infer``. The inputs
    split into ``min(chunk_sz, n)`` chunks (not chunks of ``chunk_sz``
    images), whose PSNR/RMSE/SSIM are weighted by their share of the
    images. ``evaluate(return_images=False) -> (psnr, rmse, ssim,
    images or None)``; the images come back to the host as numpy."""
    n = valid_inputs.shape[0]
    chunks = [c for c in np.array_split(np.arange(n), min(chunk_sz, n))
              if len(c)]
    v_in = torch.as_tensor(valid_inputs).to(device)
    v_gt = torch.as_tensor(valid_targets).to(device)

    @torch.no_grad()
    def evaluate(return_images: bool = False):
        infers = []
        psnr = rmse = ssim_v = 0.0
        for idx in chunks:
            x = _to_unit(v_in[idx[0]:idx[-1] + 1])
            gt = _to_unit(v_gt[idx[0]:idx[-1] + 1])
            infer = apply_fn(x)
            if return_images:
                infers.append(infer.cpu().numpy())
            p, r, s = (float(v) for v in M.psnr_rmse_ssim(infer, gt))
            frac = len(idx) / n
            psnr += p * frac
            rmse += r * frac
            ssim_v += s * frac
        images = np.concatenate(infers, 0) if return_images else None
        return psnr, rmse, ssim_v, images

    return evaluate
