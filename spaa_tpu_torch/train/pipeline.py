"""Train, validate and load PCNet and CompenNet++ (counterpart of
``spaa_tpu/train/pipeline.py``, reference ``train_network.py:98-127,
476-733``).

``train_eval_pcnet`` and ``train_eval_compennet_pp`` train their model on
every setup of a config (or load its checkpoint with ``load_pretrained``),
validate it, log the metrics table and save the inferred validation
images; ``init_compennet`` pre-trains CompenNet once for every setup.
Checkpoints live under the same config-string key ``spaa_tpu`` uses,
``<data_root>/../checkpoint/<opt_to_string>.flax``, with ``num_train``
clamped to the setup's training-pair count and the batch size to
``num_train`` (``pipeline.py:134``), in the same msgpack format, so either
package reads the other's.
"""

from __future__ import annotations

import dataclasses
import os
from os.path import join
from typing import Any, Optional

import numpy as np
import torch

from spaa_tpu_torch.models.compen_net import CompenNet, CompenNetPlusplus
from spaa_tpu_torch.models.pcnet import PCNet, PCNetCache
from spaa_tpu_torch.models.warping_net import affine_from_corners
from spaa_tpu_torch.ops import metrics as M
from spaa_tpu_torch.train.data import (as_uint8_wire, direct_light_mask,
                                       load_data, load_setup_info,
                                       nayar_separation)
from spaa_tpu_torch.train.train import (compute_loss, get_model_train_cfg,
                                        make_compennet_pp_optimizer,
                                        make_evaluator, make_pcnet_optimizer,
                                        sample_batch_indices, train_model)
from spaa_tpu_torch.utils import log as L
from spaa_tpu_torch.utils import vis
from spaa_tpu_torch.utils.device import resolve_device
from spaa_tpu_torch.utils.io import imread_dir, save_imgs
from spaa_tpu_torch.utils.seed import reset_rng_seeds
from spaa_tpu_torch.utils.threefry import prng_key
from spaa_tpu_torch.weights import (compennet_params, compennet_pp_params,
                                    pcnet_params, pcnet_state_dict)

# the cached CompenNet pre-training's checkpoint key (ref
# ``train_network.py:102``): fixed, whatever budget trained it
INIT_CKPT_NAME = "init_CompenNet_l1+ssim_500_48_500_0.001_0.2_800_0.0001"


@dataclasses.dataclass
class TrainedModel:
    """A trained PCNet or CompenNet++ with its per-setup constants, on one
    device."""
    model: Any                      # PCNet or CompenNetPlusplus, frozen
    mask: Optional[torch.Tensor]    # [H, W, 1]; None for CompenNet++
    cam_scene: torch.Tensor         # [1, H, W, 3]
    setup_info: Any
    cfg: Any
    name: str

    def apply(self, x, s, cache=None):
        if isinstance(self.model, PCNet):
            return self.model(x, s, self.mask, cache=cache)
        return self.model(x, s)

    def simplify(self) -> PCNetCache:
        """Bake PCNet's inference cache (ref ``simplify`` methods)."""
        with torch.no_grad():
            return self.model.simplify_cache(self.cam_scene)


def _make_curve_logger(cfg, data_root: str) -> vis.CurveLogger:
    """The training curves as JSONL, and live visdom lines when
    ``cfg.plot_on`` is set and a server answers (ref
    ``train_network.py:162-173``, made optional)."""
    if cfg.get("plot_on", False):
        vis.init_visdom()
    return vis.CurveLogger(join(
        data_root, "../log",
        f"curves_{cfg.get('model_name', 'model')}_"
        f"{cfg.get('setup_name', 'setup')}.jsonl"))


def _new_pcnet(model_name: str, cam_hw) -> PCNet:
    return PCNet(out_size=tuple(int(v) for v in cam_hw),
                 with_refine="w/o_refine" not in model_name,
                 use_mask="no_mask" not in model_name,
                 use_rough="no_rough" not in model_name)


def _set_affine(model: PCNet, mask_corners, inverse: bool = False) -> PCNet:
    """Initialise WarpingNet's affine from the mask's bounding box (ref
    ``train_network.py:543-547``; ``inverse`` for CompenNet++)."""
    with torch.no_grad():
        model.warping_net.affine_mat.copy_(
            affine_from_corners(mask_corners, inverse=inverse))
    return model


def _build_pcnet(model_name: str, cam_hw, mask_corners, rng_key) -> PCNet:
    """A freshly initialised PCNet (``spaa_tpu``'s initial weights for the
    root key ``rng_key``) with its affine set from the mask's corners."""
    return _set_affine(_new_pcnet(model_name, cam_hw).init_weights(rng_key),
                       mask_corners)


def _run_cfg(cfg_default, num_train: int, num_avail: int, setup_name: str,
             model_name: str, loss: str):
    """One run's config: ``num_train`` clamped to the training pairs there
    are (the reference assumes the 500-pair capture), the batch to
    ``num_train``, the sweep lists replaced by this run's entries."""
    cfg = cfg_default.copy()
    cfg.num_train = min(int(num_train), int(num_avail))
    cfg.batch_size = min(int(cfg.batch_size), cfg.num_train)
    for key in ["num_train_list", "model_list", "loss_list", "setup_list"]:
        if key in cfg:
            del cfg[key]
    cfg.model_name = model_name.replace("/", "_")
    cfg.setup_name = setup_name.replace("/", "_")
    cfg.loss = loss
    return cfg


def make_pcnet_loss(model: PCNet, scene: torch.Tensor, mask: torch.Tensor,
                    loss: str = "l1+ssim", curriculum_iter: int = 400):
    """PCNet's training loss ``loss_fn(prj, cam_gt, itr) -> (loss, l2)``:
    ``loss`` (l1+ssim) against the capture, the SSIM term only after
    iteration ``curriculum_iter`` (400: the curriculum, ref
    ``train_network.py:299-303``); the scene stays [1, H, W, 3]."""
    def loss_fn(prj, cam_gt, itr):
        return compute_loss(model(prj, scene, mask), cam_gt, loss,
                            ssim_weight=1.0 if itr > curriculum_iter else 0.0)
    return loss_fn


def _ckpt_path(cfg) -> str:
    return L.checkpoint_path(join(cfg.data_root, "../checkpoint"),
                             L.opt_to_string(cfg))


def _load_weights(model, ckpt: str, dtype=torch.float32):
    """Load a ``.flax`` checkpoint of PCNet, CompenNet or CompenNet++."""
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    model.load_state_dict(pcnet_state_dict(L.load_checkpoint(ckpt), npdt))
    return model


def _frozen(model, device, dtype=torch.float32):
    model = model.to(device, dtype).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def train_eval_pcnet(cfg_default, device=None):
    """Train and evaluate PCNet on every setup of ``cfg_default`` (a
    ``get_model_train_cfg`` config; ref ``train_network.py:476-594``).

    With ``load_pretrained`` and a checkpoint under the run's key, the
    checkpoint is loaded; otherwise PCNet trains from ``spaa_tpu``'s
    initial weights under ``reset_rng_seeds(123)`` and the checkpoint is
    written. Each run is
    validated, its metrics appended to the log table and its inferred
    validation images saved to ``cam/infer/test/<model_version>``; a mean
    row per model closes the table. Returns ``(TrainedModel of the last
    run, metrics Table, cfg)``."""
    dev = resolve_device(device)
    data_root = cfg_default.data_root
    table, log_txt, log_xls = L.init_log_file(join(data_root, "../log"))
    trained = cfg = None

    for setup_name in cfg_default.setup_list:
        data = load_data(data_root, setup_name)
        cam_hw = data["cam_train"].shape[1:3]
        scene = torch.from_numpy(data["cam_scene"]).to(dev)
        mask = torch.from_numpy(data["mask"]).to(dev)
        cam_valid = torch.from_numpy(data["cam_valid"]).to(dev)

        for num_train in cfg_default.num_train_list:
            for model_name in cfg_default.model_list:
                for loss in cfg_default.loss_list:
                    cfg = _run_cfg(cfg_default, num_train,
                                   data["prj_train"].shape[0], setup_name,
                                   model_name, loss)
                    n = cfg.num_train
                    model_version = (f"{cfg.model_name}_{loss}_{n}_"
                                     f"{cfg.batch_size}_{cfg.max_iters}")
                    key = reset_rng_seeds(123)
                    model = _build_pcnet(model_name, cam_hw,
                                         data["mask_corners"], key).to(dev)

                    print("-" * 20 + " Training Options " + "-" * 20)
                    print("\n".join(f"{k}: {v}" for k, v in cfg.items()))

                    evaluator = make_evaluator(
                        lambda x: model(x, scene, mask),
                        as_uint8_wire(data["prj_valid"]),
                        as_uint8_wire(data["cam_valid"]), dev)
                    ckpt = _ckpt_path(cfg)
                    if cfg.load_pretrained and os.path.exists(ckpt):
                        print(f"----- Loading pretrained {model_name} -----")
                        _load_weights(model, ckpt)
                    else:
                        print(f"----- Start training {model_name} -----")
                        opt, sched = make_pcnet_optimizer(model, cfg)
                        idx = sample_batch_indices(n, cfg.batch_size,
                                                   cfg.max_iters)
                        train_model(
                            make_pcnet_loss(model, scene, mask), model, opt,
                            sched,
                            dict(inputs=as_uint8_wire(data["prj_train"][:n]),
                                 targets=as_uint8_wire(data["cam_train"][:n])),
                            idx, cfg, dev, valid_fn=evaluator,
                            curve_logger=_make_curve_logger(cfg, data_root),
                            resume_path=L.resume_path(
                                join(data_root, "../checkpoint"),
                                L.opt_to_string(cfg)))
                        L.save_checkpoint(join(data_root, "../checkpoint"),
                                          pcnet_params(model.state_dict()),
                                          L.opt_to_string(cfg))

                    model = _frozen(model, dev)
                    _, _, _, cam_valid_infer = evaluator(return_images=True)
                    vals = M.calc_img_dists(
                        torch.from_numpy(cam_valid_infer).to(dev), cam_valid)
                    table.append([setup_name, model_name, loss, n,
                                  cfg.batch_size, cfg.max_iters, *vals])
                    L.write_log_file(table, log_txt, log_xls)

                    infer_path = join(data_root, "setups", setup_name,
                                      "cam/infer/test", model_version)
                    save_imgs(cam_valid_infer, infer_path)
                    print("Inferred camera-captured (relit) images saved to "
                          + infer_path)
                    trained = TrainedModel(model, mask, scene,
                                           data["setup_info"], cfg,
                                           model_name)

    for model_name in cfg_default.model_list:
        L.add_mean_row(table, model_name, len(cfg_default.setup_list))
    print(table.to_string())
    L.write_log_file(table, log_txt, log_xls)
    return trained, table, cfg


def load_pretrained_pcnet(cfg_default, setup_name: str, device=None,
                          dtype=torch.float32) -> tuple:
    """Load the trained PCNet of one setup as ``train_eval_pcnet`` would
    with ``load_pretrained`` and a checkpoint present, reading only the
    scene and the direct-light mask (no training data; the training-pair
    count comes from the ``prj_share/train`` listing).

    ``cfg_default``: a ``get_model_train_cfg`` config with one entry in
    each of ``model_list``, ``num_train_list`` and ``loss_list``.
    Returns ``(TrainedModel, cfg)``; raises ``FileNotFoundError`` if the
    checkpoint does not exist."""
    dev = resolve_device(device)
    for key in ("model_list", "num_train_list", "loss_list"):
        if len(cfg_default[key]) != 1:
            raise ValueError(f"{key} must hold one entry here; "
                             "train_eval_pcnet sweeps training variants")
    data_root = cfg_default.data_root
    setup_path = join(data_root, "setups", setup_name)
    setup_info = load_setup_info(setup_path)
    cam_scene = imread_dir(join(setup_path, "cam/raw/ref"))[1:2]
    im_direct, _ = nayar_separation(imread_dir(join(setup_path, "cam/raw/cb")),
                                    b=0.9)
    mask = direct_light_mask(im_direct).astype(np.float32)[..., None]

    train_dir = join(data_root, "prj_share/train")
    num_avail = len(os.listdir(train_dir)) if os.path.isdir(train_dir) else 0
    model_name = cfg_default.model_list[0]
    cfg = _run_cfg(cfg_default, cfg_default.num_train_list[0], num_avail,
                   setup_name, model_name, cfg_default.loss_list[0])
    ckpt = _ckpt_path(cfg)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"no trained {model_name} checkpoint at "
                                f"{ckpt}; train it with train_eval_pcnet")
    print(f"----- Loading pretrained {model_name} from {ckpt} -----")
    model = _load_weights(_new_pcnet(model_name, cam_scene.shape[1:3]), ckpt,
                          dtype)
    model = _frozen(model, dev, dtype)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return TrainedModel(model, t(mask), t(cam_scene), setup_info, cfg,
                        model_name), cfg


# ------------------------------------------------------------ CompenNet++
def make_compennet_loss(model, scene: torch.Tensor, loss: str):
    """CompenNet's or CompenNet++'s training loss ``loss_fn(cam, prj_gt,
    itr) -> (loss, l2)``: ``compute_loss`` of the inferred projector input
    against the true one, the SSIM term on from iteration 0 (no
    curriculum, ref ``train_network.py:299-303`` applies to PCNet only);
    the scene stays [1, H, W, 3]."""
    def loss_fn(cam, prj_gt, itr):
        del itr
        return compute_loss(model(cam, scene), prj_gt, loss)
    return loss_fn


def init_compennet(data_root: str, cfg, device=None) -> CompenNet:
    """CompenNet pre-trained on ``|prj_train - 0.3 * prj_share/init[0]|``
    -> ``prj_train`` (no projection needed), cached once under
    ``<data_root>/../checkpoint/INIT_CKPT_NAME.flax`` (ref
    ``train_network.py:98-127``). From ``spaa_tpu``'s draw under key 0,
    batch ``min(48, N)``, ``cfg.init_max_iters`` iterations (default 500),
    no validation. The minibatch plan continues the caller's Python RNG
    state. Returns the CompenNet on ``device``."""
    dev = resolve_device(device)
    model = CompenNet().init_weights(prng_key(0))
    ckpt = L.checkpoint_path(join(data_root, "../checkpoint"), INIT_CKPT_NAME)
    if os.path.exists(ckpt):
        print("CompenNet init checkpoint found! Loading...")
        return _load_weights(model, ckpt).to(dev)

    print("CompenNet init checkpoint not found! Initializing...")
    model = model.to(dev)
    cam_scene = imread_dir(join(data_root, "prj_share/init"))[:1]
    prj_train = imread_dir(join(data_root, "prj_share/train"))
    cam_train = np.abs(prj_train - 0.3 * cam_scene)

    init_cfg = get_model_train_cfg(["CompenNet"], data_root, single=True)
    init_cfg.max_iters = int(cfg.get("init_max_iters", 500))
    init_cfg.batch_size = min(48, prj_train.shape[0])
    init_cfg.num_train = prj_train.shape[0]
    init_cfg.valid_rate = 100
    opt, sched = make_compennet_pp_optimizer(model, init_cfg)
    idx = sample_batch_indices(init_cfg.num_train, init_cfg.batch_size,
                               init_cfg.max_iters)
    train_model(make_compennet_loss(model, torch.from_numpy(cam_scene).to(dev),
                                    "l1+ssim"),
                model, opt, sched, dict(inputs=cam_train, targets=prj_train),
                idx, init_cfg, dev, log_prefix="[init CompenNet] ")
    L.save_checkpoint(join(data_root, "../checkpoint"),
                      compennet_params(model.state_dict()), INIT_CKPT_NAME)
    return model


def train_eval_compennet_pp(cfg_default, device=None):
    """Train and evaluate CompenNet++ on every setup of ``cfg_default`` (ref
    ``train_network.py:597-733``), in ``spaa_tpu``'s order: the CompenNet
    pre-training (:func:`init_compennet`) first, on the caller's RNG
    state; then per run ``reset_rng_seeds(0)``, ``spaa_tpu``'s draw under
    key 0, WarpingNet's affine set to the INVERSE of PCNet's (it samples
    the camera image from projector space; PARITY.md "Known deviations")
    and the ``compen_net`` weights replaced by the pre-trained ones. With
    ``load_pretrained`` and a checkpoint under the run's key, it is loaded;
    otherwise CompenNet++ trains (one Adam, ``cfg.loss`` with SSIM from
    iteration 0) and the checkpoint is written. Validation maps
    ``cam/raw/test`` to ``prj_share/test``; the inferred images go to
    ``prj/infer/test/<model_version>``, and ``cam/desire/test``, where it
    exists, is compensated into ``prj/cmp/test/<model_version>``. Returns
    ``(TrainedModel of the last run, metrics Table, cfg)``."""
    dev = resolve_device(device)
    data_root = cfg_default.data_root
    table, log_txt, log_xls = L.init_log_file(join(data_root, "../log"))
    compen = init_compennet(data_root, cfg_default, dev)
    trained = cfg = None

    for setup_name in cfg_default.setup_list:
        setup_path = join(data_root, "setups", setup_name)
        data = load_data(data_root, setup_name)
        prj_hw = tuple(int(v) for v in data["prj_train"].shape[1:3])
        scene = torch.from_numpy(data["cam_scene"]).to(dev)
        prj_valid = torch.from_numpy(data["prj_valid"]).to(dev)

        for num_train in cfg_default.num_train_list:
            for model_name in cfg_default.model_list:
                for loss in cfg_default.loss_list:
                    cfg = _run_cfg(cfg_default, num_train,
                                   data["prj_train"].shape[0], setup_name,
                                   model_name, loss)
                    n = cfg.num_train
                    model_version = (f"{cfg.model_name}_{loss}_{n}_"
                                     f"{cfg.batch_size}_{cfg.max_iters}")
                    key = reset_rng_seeds(0)
                    model = CompenNetPlusplus(
                        prj_hw, with_refine="w/o_refine" not in model_name)
                    _set_affine(model.init_weights(key), data["mask_corners"],
                                inverse=True)
                    model.compen_net.load_state_dict(compen.state_dict())
                    model = model.to(dev)

                    print("-" * 20 + " Training Options " + "-" * 20)
                    print("\n".join(f"{k}: {v}" for k, v in cfg.items()))

                    evaluator = make_evaluator(
                        lambda x: model(x, scene),
                        as_uint8_wire(data["cam_valid"]),
                        as_uint8_wire(data["prj_valid"]), dev)
                    ckpt = _ckpt_path(cfg)
                    if cfg.load_pretrained and os.path.exists(ckpt):
                        print(f"----- Loading pretrained {model_name} -----")
                        _load_weights(model, ckpt)
                    else:
                        print(f"----- Start training {model_name} -----")
                        opt, sched = make_compennet_pp_optimizer(model, cfg)
                        idx = sample_batch_indices(n, cfg.batch_size,
                                                   cfg.max_iters)
                        train_model(
                            make_compennet_loss(model, scene, loss), model,
                            opt, sched,
                            dict(inputs=as_uint8_wire(data["cam_train"][:n]),
                                 targets=as_uint8_wire(data["prj_train"][:n])),
                            idx, cfg, dev, valid_fn=evaluator,
                            curve_logger=_make_curve_logger(cfg, data_root),
                            resume_path=L.resume_path(
                                join(data_root, "../checkpoint"),
                                L.opt_to_string(cfg)))
                        L.save_checkpoint(join(data_root, "../checkpoint"),
                                          compennet_pp_params(
                                              model.state_dict()),
                                          L.opt_to_string(cfg))

                    model = _frozen(model, dev)
                    _, _, _, prj_valid_infer = evaluator(return_images=True)
                    vals = M.calc_img_dists(
                        torch.from_numpy(prj_valid_infer).to(dev), prj_valid)
                    table.append([setup_name, model_name, loss, n,
                                  cfg.batch_size, cfg.max_iters, *vals])
                    L.write_log_file(table, log_txt, log_xls)

                    infer_path = join(setup_path, "prj/infer/test",
                                      model_version)
                    save_imgs(prj_valid_infer, infer_path)
                    print("Inferred projector input validation images saved "
                          "to " + infer_path)
                    # compensate the desired test images if there are any
                    # (ref train_network.py:697-719)
                    desire_path = join(setup_path, "cam/desire/test")
                    if os.path.isdir(desire_path):
                        desire = torch.from_numpy(imread_dir(desire_path))
                        with torch.no_grad():
                            prj_cmp = model(desire.to(dev), scene)
                        save_imgs(prj_cmp.cpu().numpy(),
                                  join(setup_path, "prj/cmp/test",
                                       model_version))
                    trained = TrainedModel(model, None, scene,
                                           data["setup_info"], cfg,
                                           model_name)

    for model_name in cfg_default.model_list:
        L.add_mean_row(table, model_name, len(cfg_default.setup_list))
    print(table.to_string())
    L.write_log_file(table, log_txt, log_xls)
    return trained, table, cfg
