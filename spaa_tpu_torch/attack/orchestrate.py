"""Attack orchestration of the three attackers (counterpart of
``spaa_tpu/attack/orchestrate.py``, reference
``projector_based_attack.py:24-209,342-359``).

Same attacker names, sweep grid and output layout
(``prj/adv/<attacker_cfg>/<loss>/<d_thr>/<classifier>`` and
``cam/infer/adv/...``). Per classifier, SPAA's (stealth loss x d_thr) grid
runs as one batched attack of 12 x 11 = 132 images, and PerC-AL's one
(loss, d_thr) config as one batch of 10 targeted + 1 untargeted samples;
:func:`project_capture_real_attack` replays the results through ProCams.
One-pixel DE trains nothing: it projects and captures while it attacks
(``cam/raw/adv/...``), 10 targeted attacks and 1 untargeted one.
"""

from __future__ import annotations

import copy
import itertools
from os.path import join
from typing import Optional

import numpy as np
import torch

from spaa_tpu_torch.attack.one_pixel import ProjectorOnePixelAttacker
from spaa_tpu_torch.attack.perc_al import PerC_AL
from spaa_tpu_torch.attack.spaa import (SpaaConfig, spaa_attack_batched,
                                        stealth_weights)
from spaa_tpu_torch.models.classifiers import (Classifier,
                                               load_imagenet_labels,
                                               make_logits_fn)
from spaa_tpu_torch.models.pcnet import PCNetCache
from spaa_tpu_torch.models.shading_net import SurfaceFeatures
from spaa_tpu_torch.ops.image import center_crop
from spaa_tpu_torch.ops.warp import (FixedWarp, build_fixed_warp,
                                     fixed_warp_apply)
from spaa_tpu_torch.train.data import load_setup_info
from spaa_tpu_torch.train.pipeline import (train_eval_compennet_pp,
                                           train_eval_pcnet)
from spaa_tpu_torch.train.train import get_model_train_cfg
from spaa_tpu_torch.utils.config import DictConfig
from spaa_tpu_torch.utils.device import resolve_device
from spaa_tpu_torch.utils.io import imread, save_imgs
from spaa_tpu_torch.utils.seed import reset_rng_seeds

ATTACKER_NAMES = ["SPAA", "PerC-AL+CompenNet++", "One-pixel_DE"]


def get_attacker_cfg(attacker_name: str, data_root: str, setup_list,
                     device_ids=(0,), load_pretrained: bool = False,
                     plot_on: bool = False) -> DictConfig:
    """Ref ``projector_based_attack.py:169-192``: identical grids."""
    cfg = DictConfig({})
    cfg.attacker_name = attacker_name
    cfg.classifier_names = ["inception_v3", "resnet18", "vgg16"]
    cfg.data_root = data_root
    cfg.setup_list = setup_list
    cfg.device = "cuda"
    cfg.device_ids = list(device_ids)
    cfg.load_pretrained = load_pretrained
    cfg.plot_on = plot_on
    if attacker_name == "SPAA":
        cfg.stealth_losses = ["caml2", "camdE", "camdE_caml2"]
        cfg.d_threshes = [5, 7, 9, 11]
    elif attacker_name == "PerC-AL+CompenNet++":
        cfg.stealth_losses = ["camdE"]
        cfg.d_threshes = [11]
    elif attacker_name == "One-pixel_DE":
        cfg.stealth_losses = ["-"]
        cfg.d_threshes = ["-"]
    else:
        raise ValueError(f"{attacker_name} not supported!")
    return cfg


def to_attacker_cfg_str(attacker_name: str):
    """Ref ``projector_based_attack.py:195-209``: directory-name scheme."""
    if attacker_name not in ATTACKER_NAMES:
        raise ValueError(f"{attacker_name} not supported!")
    if attacker_name == "SPAA":
        mc = get_model_train_cfg(["PCNet"], single=True)
        model_cfg_str = (f"{mc.model_name}_{mc.loss}_{mc.num_train}_"
                         f"{mc.batch_size}_{mc.max_iters}")
        return f"{attacker_name}_{model_cfg_str}", model_cfg_str
    if attacker_name == "PerC-AL+CompenNet++":
        mc = get_model_train_cfg(["CompenNet++"], single=True)
        model_cfg_str = (f"{mc.model_name}_{mc.loss}_{mc.num_train}_"
                         f"{mc.batch_size}_{mc.max_iters}")
        return (f"{attacker_name}_{mc.loss}_{mc.num_train}_{mc.batch_size}_"
                f"{mc.max_iters}", model_cfg_str)
    return attacker_name, None


def perc_al_compennet_pp(compennet_pp_apply, classifier: Classifier,
                         imagenet_labels, target_idx, targeted, cam_scene,
                         d_thr, setup_info, max_iterations: int = 50):
    """The two-stage attacker (ref ``projector_based_attack.py:342-359``):
    PerC-AL's projector variant on the camera image, then CompenNet++
    compensates the result into a projector input.
    ``compennet_pp_apply(cam, scene) -> prj``; cam_scene [1, H, W, 3].

    ``targeted`` is a bool (the reference's calls) or per-sample bools (the
    fused batch of 10 targeted + 1 untargeted). The confidence margin is
    0 for a targeted call and 40 otherwise; in a fused batch it is 40 and
    applies to the untargeted samples only (the reference builds its
    targeted attacker with confidence 0, a no-op for targeted masks).
    Returns ``(cam_infer_best, prj_adv_best)``, NHWC."""
    num_target = len(target_idx)
    cam_scene_b = cam_scene.expand(num_target, *cam_scene.shape[1:])
    if isinstance(targeted, (bool, np.bool_)):
        confidence = 0 if targeted else 40
    else:
        confidence = 40
    attacker = PerC_AL(max_iterations=max_iterations, alpha_l_init=1.0,
                       alpha_c_init=0.5, confidence=confidence)
    cp_sz = tuple(int(c) for c in setup_info["classifier_crop_sz"])
    cam_infer_best = attacker.adversary_projector(
        make_attack_logits_fn(classifier, cp_sz), cam_scene_b,
        np.asarray(target_idx), imagenet_labels=imagenet_labels, d_thr=d_thr,
        targeted=targeted)
    with torch.no_grad():
        prj_adv_best = compennet_pp_apply(cam_infer_best, cam_scene_b)
    return cam_infer_best, prj_adv_best


def pcnet_warp(trained, cache: Optional[PCNetCache] = None) -> FixedWarp:
    """The fixed-grid warp tables of a trained PCNet: its baked grid with
    the binary direct-light mask folded into the weights (exact, since
    PCNet multiplies the warped image by the mask right after)."""
    if cache is None:
        cache = trained.simplify()
    sinfo = trained.setup_info
    prj_hw = (int(sinfo["prj_im_sz"][1]), int(sinfo["prj_im_sz"][0]))
    dstw = None
    if trained.mask is not None and trained.model.use_mask:
        m = trained.mask.detach().cpu().numpy()
        dstw = m[..., 0] if m.ndim == 3 else m
        # x*m*m == x*m only for a 0/1 mask: a fractional mask would be
        # squared silently, so refuse to fold one
        if not np.all((dstw == 0.0) | (dstw == 1.0)):
            raise ValueError("direct-light mask must be binary to fold into "
                             "the warp weights")
    return build_fixed_warp(cache.fine_grid, prj_hw, dst_weight=dstw,
                            dtype=cache.fine_grid.dtype,
                            device=cache.fine_grid.device)


def make_pcnet_fn(trained, compute_dtype: Optional[str] = None):
    """Frozen PCNet forward with the baked grid: ``pcnet_apply(prj) ->
    cam_infer`` on NHWC tensors, differentiable w.r.t. ``prj``.

    The warp runs through the fixed-grid kernel (``ops.warp``, tables from
    :func:`pcnet_warp`). ``compute_dtype`` (default: the model's own type)
    is the shading CNN's type, as in ``spaa_tpu``; the warp keeps the
    projector image's type (float32 on the card) either way."""
    model, scene, mask = trained.model, trained.cam_scene, trained.mask
    cdtype = getattr(torch, compute_dtype) if compute_dtype else scene.dtype
    cache = trained.simplify()
    warp = pcnet_warp(trained, cache)
    sf = cache.surface_feats
    if cdtype != scene.dtype:
        model = copy.deepcopy(model).to(cdtype)
        scene = scene.to(cdtype)
        mask = None if mask is None else mask.to(cdtype)
        sf = None if sf is None else SurfaceFeatures(*(t.to(cdtype)
                                                       for t in sf))
    cache = PCNetCache(None, sf)

    def pcnet_apply(prj: torch.Tensor) -> torch.Tensor:
        # the scene stays [1, H, W, 3]: ShadingNet runs its scene-only
        # chain once and broadcasts at the final add
        warped = fixed_warp_apply(warp, prj).to(cdtype)
        return model(prj, scene, mask, cache=cache,
                     warped=warped).to(prj.dtype)

    return pcnet_apply


def make_attack_logits_fn(classifier: Classifier, cp_sz,
                          compute_dtype: Optional[str] = None):
    """Classifier forward for the attack loop: crop to ``cp_sz``, compute
    in ``compute_dtype`` (default: the net's own type), logits out in the
    image's type."""
    net = classifier.net
    if compute_dtype and getattr(torch, compute_dtype) != \
            next(net.parameters()).dtype:
        net = copy.deepcopy(net).to(getattr(torch, compute_dtype))
    cdtype = next(net.parameters()).dtype
    inner = make_logits_fn(net, cp_sz)

    def logits_fn(im: torch.Tensor) -> torch.Tensor:
        return inner(im.to(cdtype)).to(im.dtype)

    return logits_fn


def build_spaa_sweep_arrays(cfg, setup_info, target_idx, true_idx):
    """Per-sample arrays of the fused (stealth loss x d_thr) sweep, as
    numpy: config ci occupies rows [ci*per_cfg, (ci+1)*per_cfg) as n
    targeted samples then 1 untargeted (ref ``:79-81,136-139``); the
    camdE-active configs come last so CIEDE2000 runs on one contiguous
    slice (``SpaaConfig.camde_range``). Returns ``(configs, per_cfg,
    prj_init, tgt, targeted, w, dt, spaa_cfg)``."""
    configs = [(sl, d) for sl in cfg.stealth_losses for d in cfg.d_threshes]
    configs.sort(key=lambda c: stealth_weights(c[0])[2] > 0)
    n = len(target_idx)
    per_cfg = n + 1
    b = len(configs) * per_cfg
    n_camde = sum(1 for sl, _ in configs if stealth_weights(sl)[2] > 0)
    camde_range = ((len(configs) - n_camde) * per_cfg, b)

    ph, pw = setup_info["prj_im_sz"][1], setup_info["prj_im_sz"][0]
    prj_init = np.full((b, ph, pw, 3), float(setup_info["prj_brightness"]),
                       np.float32)
    tgt = np.zeros(b, np.int64)
    targeted = np.zeros(b, bool)
    w = np.zeros((b, 3), np.float32)
    dt = np.zeros(b, np.float32)
    for ci, (sl, d) in enumerate(configs):
        s = ci * per_cfg
        tgt[s:s + n] = target_idx
        targeted[s:s + n] = True
        tgt[s + n] = true_idx
        targeted[s + n] = False
        w[s:s + per_cfg] = stealth_weights(sl)
        dt[s:s + per_cfg] = float(d)
    spaa_cfg = SpaaConfig(iters=int(cfg.get("attack_iters", 50)),
                          camde_range=camde_range)
    return configs, per_cfg, prj_init, tgt, targeted, w, dt, spaa_cfg


def save_spaa_sweep_outputs(cam_best, prj_best, configs, per_cfg,
                            setup_path, attacker_cfg_str, classifier_name):
    """Unpack the fused sweep into the reference layout (targeted 1..n,
    then the untargeted one as image n+1, ref ``:136-139``)."""
    cam_best = cam_best.detach().cpu().numpy()
    prj_best = prj_best.detach().cpu().numpy()
    for ci, (stealth_loss, d_thr) in enumerate(configs):
        s = ci * per_cfg
        folder = join(attacker_cfg_str, stealth_loss, str(d_thr),
                      classifier_name)
        save_imgs(cam_best[s:s + per_cfg],
                  join(setup_path, "cam/infer/adv", folder))
        save_imgs(prj_best[s:s + per_cfg], join(setup_path, "prj/adv", folder))


def _run_spaa_sweep(cfg, trained, classifier, cam_scene, target_idx,
                    true_idx, setup_info, setup_path, attacker_cfg_str,
                    classifier_name):
    """All (stealth loss x d_thr) configs x (10 targeted + 1 untargeted)
    as ONE batched attack, then the reference directory layout. Returns
    ``(cam_best, prj_best)`` (NHWC tensors)."""
    dev = cam_scene.device
    cp_sz = tuple(int(c) for c in setup_info["classifier_crop_sz"])
    compute_dtype = cfg.get("attack_dtype")
    pcnet_apply = make_pcnet_fn(trained, compute_dtype=compute_dtype)
    logits_fn = make_attack_logits_fn(classifier, cp_sz, compute_dtype)
    (configs, per_cfg, prj_init, tgt, targeted, w, dt,
     spaa_cfg) = build_spaa_sweep_arrays(cfg, setup_info, target_idx,
                                         true_idx)
    fdt = cam_scene.dtype

    def t(a, dtype=fdt):
        return torch.from_numpy(a).to(dev, dtype)

    cam_best, prj_best = spaa_attack_batched(
        pcnet_apply, logits_fn, cam_scene, t(prj_init), t(tgt, torch.long),
        t(targeted, torch.bool), t(w), t(dt), spaa_cfg)
    save_spaa_sweep_outputs(cam_best, prj_best, configs, per_cfg, setup_path,
                            attacker_cfg_str, classifier_name)
    print(f"  [SPAA] {len(configs)} configs x {per_cfg} attacks done in one "
          f"batched run (batch {prj_init.shape[0]})")
    return cam_best, prj_best


def _run_percal_sweep(cfg, trained, classifier, cam_scene, target_idx,
                      true_idx, setup_info, setup_path, attacker_cfg_str,
                      classifier_name, imagenet_labels):
    """Per (stealth loss, d_thr) config, the 10 targeted + 1 untargeted
    samples as ONE PerC-AL batch (per-sample normalisation makes it the
    reference's two runs), then the reference directory layout. Returns
    the last config's ``(cam_infer_best, prj_adv_best)``."""
    out = None
    for stealth_loss in cfg.stealth_losses:
        for d_thr in cfg.d_threshes:
            folder = join(attacker_cfg_str, stealth_loss, str(d_thr),
                          classifier_name)
            all_idx = list(target_idx) + [true_idx]
            targeted = np.asarray([True] * len(target_idx) + [False])
            out = perc_al_compennet_pp(
                trained.apply, classifier, imagenet_labels, all_idx,
                targeted, cam_scene, d_thr, setup_info,
                max_iterations=int(cfg.get("attack_iters", 50)))
            cam_all, prj_all = (t.detach().cpu().numpy() for t in out)
            save_imgs(cam_all, join(setup_path, "cam/infer/adv", folder))
            save_imgs(prj_all, join(setup_path, "prj/adv", folder))
    return out


def _run_one_pixel(cfg, one_pixel_de, classifier, im_prj_org, target_idx,
                   true_idx, true_label, setup_path, attacker_cfg_str,
                   classifier_name, n):
    """The untargeted attack, then the n targeted ones (ref ``:110-134``);
    the targeted images are saved as 1..n, the untargeted one as n+1, in
    ``prj/adv`` and ``cam/raw/adv``. The ``cfg.op_*`` entries override the
    reference's DE budget (block 41 pixels, 4 generations, population 50
    untargeted and 10 targeted). Returns the attacks' result tables, each
    config's untargeted one first."""
    tables = []
    pixel_size = int(cfg.get("op_pixel_size", 41))
    maxiter = int(cfg.get("op_maxiter", 4))
    pop_u = int(cfg.get("op_popsize_untargeted", 50))
    pop_t = int(cfg.get("op_popsize_targeted", 10))
    for stealth_loss in cfg.stealth_losses:
        for d_thr in cfg.d_threshes:
            folder = join(attacker_cfg_str, stealth_loss, str(d_thr),
                          classifier_name)
            cam_raw_adv_path = join(setup_path, "cam/raw/adv", folder)
            prj_adv_path = join(setup_path, "prj/adv", folder)
            table, prj_u, cam_u = one_pixel_de(
                im_prj_org, classifier, False, target_idx=true_idx,
                pixel_count=1, pixel_size=pixel_size, maxiter=maxiter,
                popsize=pop_u, verbose=True, true_label=true_label)
            tables.append(table)
            for i in range(n):
                table, prj_t, cam_t = one_pixel_de(
                    im_prj_org, classifier, True, target_idx=target_idx[i],
                    pixel_count=1, pixel_size=pixel_size, maxiter=maxiter,
                    popsize=pop_t, verbose=True, true_label=true_label)
                tables.append(table)
                save_imgs(cam_t[None], cam_raw_adv_path, idx=i)
                save_imgs(prj_t[None], prj_adv_path, idx=i)
            save_imgs(cam_u[None], cam_raw_adv_path, idx=n)
            save_imgs(prj_u[None], prj_adv_path, idx=n)
    return tables


def attack_labels(data_root: str, n: int = 10):
    """The ImageNet labels and the first ``n`` target classes of the
    10-class list (ref ``projector_based_attack.py:79-81``)."""
    imagenet_labels = load_imagenet_labels(
        join(data_root, "imagenet1000_clsidx_to_labels.txt"))
    target_labels = load_imagenet_labels(
        join(data_root, "imagenet10_clsidx_to_labels.txt"))
    return imagenet_labels, list(itertools.islice(target_labels.keys(), n))


def load_attack_setup(data_root: str, setup_name: str, dev):
    """One setup's path, info, classifier crop size and reference camera
    scene [1, H, W, 3] on ``dev`` (ref ``projector_based_attack.py:31-44``)."""
    setup_path = join(data_root, "setups", setup_name)
    setup_info = load_setup_info(setup_path)
    cp_sz = tuple(int(c) for c in setup_info["classifier_crop_sz"])
    w_cam, h_cam = setup_info["cam_im_sz"]
    cam_scene = center_crop(torch.from_numpy(
        imread(join(setup_path, "cam/raw/ref/img_0002.png")))[None],
        (h_cam, w_cam)).to(dev)
    return setup_path, setup_info, cp_sz, cam_scene


def train_attacker_model(cfg, setup_name: str, dev):
    """The attacker's model of one setup (PCNet for SPAA, CompenNet++ for
    PerC-AL), trained, or with ``cfg.load_pretrained`` and a checkpoint
    under its config-string key loaded, through ``train.pipeline``;
    ``cfg.max_iters`` overrides its training budget and
    ``cfg.init_max_iters`` CompenNet's pre-training. Sets
    ``cfg.model_cfg``; returns the ``TrainedModel``."""
    model_cfg = get_model_train_cfg(
        None, cfg.data_root, [setup_name],
        load_pretrained=cfg.load_pretrained, plot_on=cfg.plot_on)
    if "max_iters" in cfg:
        model_cfg.max_iters = cfg.max_iters
    if cfg.attacker_name == "SPAA":
        model_cfg.model_list = ["PCNet"]
        trained, _, model_cfg = train_eval_pcnet(model_cfg, dev)
    else:
        model_cfg.model_list = ["CompenNet++"]
        if "init_max_iters" in cfg:
            model_cfg.init_max_iters = cfg.init_max_iters
        trained, _, model_cfg = train_eval_compennet_pp(model_cfg, dev)
    cfg.model_cfg = dict(model_cfg)
    return trained


def run_projector_based_attack(cfg, procams=None,
                               weights_dir: Optional[str] = None,
                               device=None):
    """Sweep entry point (ref ``projector_based_attack.py:24-148``).

    ``procams``: the project-and-capture object One-pixel DE attacks
    through (``utils.sim_procams.SimProCams``); the other attackers ignore
    it. ``weights_dir``: where to look for classifier ``.pth`` files. The
    attacker's model comes from :func:`train_attacker_model`."""
    dev = resolve_device(device)
    attacker_name = cfg.attacker_name
    if attacker_name not in ATTACKER_NAMES:
        raise ValueError(f"{attacker_name} not supported!")
    assert (attacker_name != "One-pixel_DE") or (len(cfg.setup_list) == 1), \
        f"{attacker_name} does not support attacking multiple setups " \
        "simultaneously!"
    reset_rng_seeds(0)

    n = 10  # 10 targeted + 1 untargeted (ref :79-81)
    imagenet_labels, target_idx = attack_labels(cfg.data_root, n)
    for setup_name in cfg.setup_list:
        print(f"\nPerforming [{attacker_name}] attack on [{setup_name}]")
        setup_path, setup_info, cp_sz, cam_scene = load_attack_setup(
            cfg.data_root, setup_name, dev)

        dl_based = attacker_name != "One-pixel_DE"
        if dl_based:
            trained = train_attacker_model(cfg, setup_name, dev)
        else:
            assert procams is not None, \
                "One-pixel_DE needs a procams (hardware or simulator)"
            one_pixel_de = ProjectorOnePixelAttacker(imagenet_labels,
                                                     setup_info, procams)
            ph, pw = setup_info["prj_im_sz"][1], setup_info["prj_im_sz"][0]
            im_prj_org = np.full((ph, pw, 3),
                                 float(setup_info["prj_brightness"]),
                                 np.float32)
            one_pixel_de.im_cam_org = cam_scene[0].cpu().numpy()
        attacker_cfg_str = to_attacker_cfg_str(attacker_name)[0]

        for classifier_name in cfg.classifier_names:
            classifier = Classifier(classifier_name, weights_dir,
                                    sort_results=dl_based, device=dev)
            _, p, pred_idx = classifier(cam_scene, cp_sz)
            true_idx = int(pred_idx[0, 0]) if dl_based else int(p.argmax())
            true_label = imagenet_labels[true_idx]
            print(f"\n---- [{attacker_name}] attacking [{classifier_name}], "
                  f"original prediction: ({true_label}, "
                  f"p={p.max():.2f}) ----")
            if attacker_name == "SPAA":
                _run_spaa_sweep(cfg, trained, classifier, cam_scene,
                                target_idx, true_idx, setup_info, setup_path,
                                attacker_cfg_str, classifier_name)
            elif attacker_name == "PerC-AL+CompenNet++":
                _run_percal_sweep(cfg, trained, classifier, cam_scene,
                                  target_idx, true_idx, setup_info,
                                  setup_path, attacker_cfg_str,
                                  classifier_name, imagenet_labels)
            else:
                _run_one_pixel(cfg, one_pixel_de, classifier, im_prj_org,
                               target_idx, true_idx, true_label, setup_path,
                               attacker_cfg_str, classifier_name, n)

        if dl_based:
            print(f"\nThe next step is to project and capture "
                  f"[{attacker_name}] generated adversarial projections in "
                  f"{join(setup_path, 'prj/adv', attacker_cfg_str)}")
    return cfg


def project_capture_real_attack(cfg, procams) -> None:
    """Replay the adversarial projections of one setup through (simulated)
    ProCams into ``cam/raw/adv/<cfg>`` (ref
    ``projector_based_attack.py:151-166``). ``procams``: any object with
    ``project_capture_data`` (``utils.sim_procams.SimProCams``)."""
    attacker_name = cfg.attacker_name
    assert attacker_name in ["SPAA", "PerC-AL+CompenNet++"], \
        f"{attacker_name} not supported, One-pixel_DE does not use this " \
        "function!"
    assert len(cfg.setup_list) == 1

    setup_path = join(cfg.data_root, "setups", cfg.setup_list[0])
    setup_info = load_setup_info(setup_path)
    attacker_cfg_str = to_attacker_cfg_str(attacker_name)[0]
    for stealth_loss in cfg.stealth_losses:
        for d_thr in cfg.d_threshes:
            for classifier_name in cfg.classifier_names:
                folder = join(attacker_cfg_str, stealth_loss, str(d_thr),
                              classifier_name)
                procams.project_capture_data(
                    join(setup_path, "prj/adv", folder),
                    join(setup_path, "cam/raw/adv", folder), setup_info)
