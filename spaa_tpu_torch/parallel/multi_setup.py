"""Setup-parallel training and attack waves (counterpart of
``spaa_tpu/parallel/multi_setup.py``).

The reference trains and attacks its 13 setups strictly one after the
other (``reproduce_paper_results.py:63-65``). The setups share nothing,
so here:

- **training** gives each device its share of the S setups, which it
  trains one after the other through ``train.train.train_model``, each
  with its own optimizer: the sequential pipeline's program. With a mesh
  of n devices each device runs in its own host thread, and no tensor
  crosses devices. (``spaa_tpu`` stacks the setups on one device under
  ``jax.vmap``; ``torch.func.vmap`` of the same step was measured 2.2-2.5x
  slower than the plain steps on one H100, ``ROADMAP.md`` queue C);
- **attacks** run in waves of one setup per device, each device running
  the unmodified production loop (``attack.spaa.spaa_attack_batched`` or
  ``attack.perc_al.perc_al_core``) in its own host thread; a wave of one
  is the sequential driver's own program.

The cache fillers (:func:`pretrain_pcnets_multi_setup`,
:func:`pretrain_compennets_pp_multi_setup`) save each setup's checkpoint
under the key ``train.pipeline`` reads, and the wave drivers write the
sequential driver's directory layout.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from spaa_tpu_torch.parallel.mesh import (Mesh, _to, _tree_map, make_mesh,
                                          replicate)


def stack_setups(trees):
    """Stack a list of state dicts with the same keys and shapes along a
    new leading (setup) axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_setups(tree, num_setups: int):
    """Inverse of :func:`stack_setups`: stacked state dict -> list of
    state dicts."""
    return [{k: v[i] for k, v in tree.items()} for i in range(num_setups)]


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


def _per_device(fn, devices, *per_device_args) -> list:
    """``fn(dev, *args)`` for each device in its own host thread (inline for
    one device); the results in device order. A thread's exception is
    raised here."""
    def run(dev, *args):
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return fn(dev, *args)

    calls = [(d, *(a[k] for a in per_device_args))
             for k, d in enumerate(devices)]
    if len(calls) == 1:
        return [run(*calls[0])]
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(run, *c) for c in calls]
        return [f.result() for f in futures]


def _train_setups(dev, model, tx, params_list, scenes, masks, inputs,
                  targets, batch_idx, loss_option, curriculum_iter, variant,
                  segment):
    """Train the setups of one device one after the other, each with its
    own optimizer through ``train.train.train_model``: the sequential
    pipeline's program. Returns (state dicts, losses [iters, k], l2s
    [iters, k]) with the losses on the host."""
    from spaa_tpu_torch.train.pipeline import (make_compennet_loss,
                                               make_pcnet_loss)
    from spaa_tpu_torch.train.train import train_model
    if variant not in ("pcnet", "compennet_pp"):
        raise ValueError(f"unknown variant {variant!r}")
    dtype = next(iter(params_list[0].values())).dtype
    n = len(batch_idx)
    cfg = SimpleNamespace(max_iters=n, valid_rate=n if segment is None
                          else max(1, min(int(segment), n)))
    states, curves = [], []
    for s, params in enumerate(params_list):
        net = copy.deepcopy(model).to(dev, dtype)
        net.load_state_dict(params)
        scene = _tensor(scenes[s], dev).to(dtype)
        if variant == "pcnet":
            loss_fn = make_pcnet_loss(net, scene,
                                      _tensor(masks[s], dev).to(dtype),
                                      loss_option, curriculum_iter)
        else:
            loss_fn = make_compennet_loss(net, scene, loss_option)
        opt, sched = tx(net)
        curve = []
        train_model(loss_fn, net, opt, sched,
                    dict(inputs=inputs[s], targets=targets[s]), batch_idx,
                    cfg, dev, log_prefix=f"[setup {s}] ", step_losses=curve)
        states.append({k: v.detach().clone()
                       for k, v in net.state_dict().items()})
        curves.append(curve)
    out = np.asarray(curves, torch.empty((), dtype=dtype).numpy().dtype)
    return states, out[..., 0].T, out[..., 1].T


def train_pcnet_multi_setup(model: torch.nn.Module, params_list, tx,
                            scenes, masks, inputs, targets,
                            batch_idx: np.ndarray,
                            mesh: Optional[Mesh] = None,
                            axis: str = "setup",
                            loss_option: str = "l1+ssim",
                            curriculum_iter: int = 400,
                            use_scan: Optional[bool] = None,
                            variant: str = "pcnet",
                            segment: Optional[int] = 200):
    """Train S independent PCNets, S / n on each of the n devices.

    model:       the shared architecture (its own weights are not used;
                 the counterpart of ``spaa_tpu``'s ``model.apply``).
    params_list: S per-setup state dicts (same keys and shapes).
    tx:          optimizer factory ``tx(module) -> (optimizer, scheduler
                 or None)``, e.g. ``lambda m: make_pcnet_optimizer(m, cfg)``;
                 each setup gets its own.
    scenes:      [S, 1, H, W, 3] camera scenes (or [S, H, W, 3]).
    masks:       [S, H, W, 1] direct-light masks.
    inputs/targets: [S, N, h, w, 3] / [S, N, H, W, 3] train pairs, or S
                 lists of them (uint8 recommended: cast on the device per
                 minibatch).
    batch_idx:   [iters, batch] minibatch plan shared by the setups (each
                 reseeds 123, so their plans are equal).
    mesh:        S must divide by its size; each device trains S/n setups
                 in its own host thread. None: the device of the first
                 setup's parameters.
    segment:     iterations between two host reads of the losses (default
                 200, the production ``valid_rate``; None: one read at the
                 end). The trajectory does not depend on it.
    use_scan:    accepted for ``spaa_tpu``'s argument list and ignored: the
                 port's loop is a Python loop on every device.

    ``spaa_tpu`` steps the setups of a device as one ``vmap`` program; here
    each setup is ``train_model``'s module step, one setup after the
    other, so one setup's call is the sequential pipeline's program.
    Returns (list of S state dicts, losses [iters, S], l2s [iters, S])."""
    del use_scan
    num_setups = len(params_list)
    if mesh is not None and num_setups % mesh.size != 0:
        raise ValueError(f"{num_setups} setups not divisible by the "
                         f"{mesh.size}-device mesh")
    scenes = np.asarray(scenes) if not isinstance(scenes, torch.Tensor) \
        else scenes
    if scenes.ndim == 4:                       # [S, H, W, 3] -> [S, 1, ...]
        scenes = scenes[:, None]
    devs = mesh.devices if mesh is not None else \
        (next(iter(params_list[0].values())).device,)
    k = num_setups // len(devs)

    def part(a):
        return [a[g * k:(g + 1) * k] for g in range(len(devs))]

    outs = _per_device(
        lambda dev, p, s, m, i, t: _train_setups(
            dev, model, tx, p, s, m, i, t, batch_idx, loss_option,
            curriculum_iter, variant, segment),
        devs, part(params_list), part(scenes), part(masks), part(inputs),
        part(targets))
    states = [s for o in outs for s in o[0]]
    return (states, np.concatenate([o[1] for o in outs], 1),
            np.concatenate([o[2] for o in outs], 1))


def train_compennet_pp_multi_setup(model: torch.nn.Module, params_list, tx,
                                   scenes, inputs, targets,
                                   batch_idx: np.ndarray,
                                   mesh: Optional[Mesh] = None,
                                   axis: str = "setup",
                                   loss_option: str = "l1+ssim",
                                   use_scan: Optional[bool] = None):
    """CompenNet++ form of :func:`train_pcnet_multi_setup`: ``model(cam,
    scene)`` (no mask), no SSIM curriculum, inputs = camera captures and
    targets = projector images (the compensation direction, ref
    ``train_network.py:597-733``)."""
    masks = np.zeros((len(params_list), 1, 1, 1), np.float32)  # unused
    return train_pcnet_multi_setup(
        model, params_list, tx, scenes, masks, inputs, targets, batch_idx,
        mesh=mesh, axis=axis, loss_option=loss_option, use_scan=use_scan,
        variant="compennet_pp")


def _placement(mesh, device):
    """A driver's (mesh, device): an explicit mesh brings its devices;
    ``mesh="auto"`` takes every visible CUDA device when there are more
    than one, else none; without a mesh, ``device`` (default ``cuda``)."""
    from spaa_tpu_torch.utils.device import resolve_device
    if isinstance(mesh, Mesh):
        return mesh, resolve_device(mesh.devices[0])
    dev = resolve_device(device)
    if isinstance(mesh, str):
        assert mesh == "auto", f"unrecognized mesh={mesh!r}"
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        if n_dev > 1:
            mesh = make_mesh(n_dev, axis="setup")
            return mesh, mesh.devices[0]
        mesh = None
    return mesh, dev


def pretrain_pcnets_multi_setup(cfg_default, mesh="auto",
                                chunk: Optional[int] = None, device=None):
    """Fill the PCNet checkpoint cache for every setup of
    ``cfg_default.setup_list``, ``chunk`` setups per training step instead
    of the reference's sequential loop (``train_network.py:476-594``).

    Checkpoints are saved under ``train_eval_pcnet``'s exact key
    (``utils.log.opt_to_string``), so the per-setup pipeline run with
    ``load_pretrained=True`` afterwards loads them and still writes its
    validation tables, images and log rows.

    cfg_default: the ``get_model_train_cfg(["PCNet"], ...)`` sweep form,
    with single-element model, loss and ``num_train`` lists. Cached setups
    are skipped; the rest are grouped by tensor shape, and a chunk that the
    mesh does not divide trains on one device.

    ``mesh="auto"``: every visible CUDA device when there are more than one,
    else none (``device``, default ``cuda``). ``chunk`` defaults to the mesh
    size (one setup per device), or 1.

    Returns a list of dicts: setup, status (trained | cached), and PSNR,
    RMSE, SSIM of the final validation of the trained setups."""
    return _pretrain_multi_setup(cfg_default, mesh, chunk, "PCNet", device)


def pretrain_compennets_pp_multi_setup(cfg_default, mesh="auto",
                                       chunk: Optional[int] = None,
                                       device=None):
    """CompenNet++ twin of :func:`pretrain_pcnets_multi_setup`, under
    ``train_eval_compennet_pp``'s keys (ref ``train_network.py:597-733``).
    The shared CompenNet pre-training (``init_compennet``) runs or loads
    once up front, as the sequential pipeline does."""
    return _pretrain_multi_setup(cfg_default, mesh, chunk, "CompenNet++",
                                 device)


def _pretrain_multi_setup(cfg_default, mesh, chunk, model_name: str,
                          device):
    """The two cache fillers' scaffold; the model's optimizer, initial
    draw and the directions of training and validation branch on
    ``model_name``."""
    from spaa_tpu_torch.models.compen_net import CompenNetPlusplus
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.train.data import as_uint8_wire, load_data
    from spaa_tpu_torch.train.train import (make_compennet_pp_optimizer,
                                            make_evaluator,
                                            make_pcnet_optimizer,
                                            sample_batch_indices)
    from spaa_tpu_torch.utils import log as L
    from spaa_tpu_torch.utils.seed import reset_rng_seeds
    from spaa_tpu_torch.weights import pcnet_params

    is_pcnet = model_name == "PCNet"
    mesh, dev = _placement(mesh, device)
    if chunk is None:
        chunk = mesh.size if mesh is not None else 1
    assert chunk >= 1

    for k, n in [("model_list", 1), ("num_train_list", 1), ("loss_list", 1)]:
        assert len(cfg_default[k]) == n, \
            f"multi-setup pretraining supports only single-element {k}"
    assert cfg_default.model_list[0] == model_name, \
        f"only the full {model_name} architecture is setup-batchable here"

    data_root = cfg_default.data_root
    ckpt_dir = join(data_root, "../checkpoint")
    if not is_pcnet:
        compen = P.init_compennet(data_root, cfg_default, dev)

    # the key needs only the training-pair count (the prj_share/train
    # listing, which load_data reads whole): a cached setup loads nothing
    num_avail = len(os.listdir(join(data_root, "prj_share/train")))
    rows, jobs = [], []
    for setup_name in cfg_default.setup_list:
        cfg = P._run_cfg(cfg_default, cfg_default.num_train_list[0],
                         num_avail, setup_name, model_name,
                         cfg_default.loss_list[0])
        title = L.opt_to_string(cfg)
        if os.path.exists(L.checkpoint_path(ckpt_dir, title)):
            rows.append(dict(setup=setup_name, status="cached"))
            continue
        data = load_data(data_root, setup_name)
        jobs.append(dict(setup=setup_name, data=data, cfg=cfg, title=title,
                         key=(data["cam_train"].shape[1:3],
                              data["prj_train"].shape[1:3],
                              cfg.num_train, int(cfg.batch_size))))

    groups: dict = {}
    for j in jobs:
        groups.setdefault(j["key"], []).append(j)

    make_optimizer = make_pcnet_optimizer if is_pcnet \
        else make_compennet_pp_optimizer
    for group in groups.values():
        cfg = group[0]["cfg"]

        def tx(m, _cfg=cfg):
            return make_optimizer(m, _cfg)
        for lo in range(0, len(group), chunk):
            ch = group[lo:lo + chunk]
            ch_mesh = mesh
            if mesh is not None and len(ch) % mesh.size != 0:
                ch_mesh = None   # remainder chunk: one device
            model, params_list, idx = None, [], None
            for j in ch:
                cam_hw, prj_hw = j["key"][0], j["key"][1]
                corners = j["data"]["mask_corners"]
                if is_pcnet:
                    # train_eval_pcnet's draws: reseed 123, build (affine
                    # from this setup's mask corners), then the plan
                    model = P._build_pcnet("PCNet", cam_hw, corners,
                                           reset_rng_seeds(123))
                else:
                    # train_eval_compennet_pp's: reseed 0, the INVERSE
                    # affine, the shared pre-trained CompenNet spliced in
                    model = CompenNetPlusplus(tuple(int(v) for v in prj_hw))
                    P._set_affine(model.init_weights(reset_rng_seeds(0)),
                                  corners, inverse=True)
                    model.compen_net.load_state_dict(compen.state_dict())
                params_list.append({k: v.to(dev) for k, v in
                                    model.state_dict().items()})
                idx = sample_batch_indices(cfg.num_train, cfg.batch_size,
                                           cfg.max_iters)
            print(f"----- multi-setup training {len(ch)} {model_name}: "
                  f"{[j['setup'] for j in ch]} -----")
            n = cfg.num_train
            scenes = np.stack([j["data"]["cam_scene"] for j in ch])
            prj = [as_uint8_wire(j["data"]["prj_train"][:n]) for j in ch]
            cam = [as_uint8_wire(j["data"]["cam_train"][:n]) for j in ch]
            if is_pcnet:
                out_params, losses, _ = train_pcnet_multi_setup(
                    model, params_list, tx, scenes,
                    np.stack([j["data"]["mask"] for j in ch]), prj, cam, idx,
                    mesh=ch_mesh, curriculum_iter=400, loss_option=cfg.loss)
            else:                          # compensation direction
                out_params, losses, _ = train_compennet_pp_multi_setup(
                    model, params_list, tx, scenes, cam, prj, idx,
                    mesh=ch_mesh, loss_option=cfg.loss)
            if not np.isfinite(losses[-1]).all():
                raise FloatingPointError(
                    f"non-finite training loss in multi-setup chunk "
                    f"{[j['setup'] for j in ch]}")
            for s, j in enumerate(ch):
                L.save_checkpoint(ckpt_dir, pcnet_params(out_params[s]),
                                  j["title"])
                d = j["data"]
                model.load_state_dict(out_params[s])
                net = P._frozen(model, dev)
                scene = torch.from_numpy(d["cam_scene"]).to(dev)
                if is_pcnet:
                    mask = torch.from_numpy(d["mask"]).to(dev)

                    def apply_fn(x, _n=net, _s=scene, _m=mask):
                        return _n(x, _s, _m)
                    v_in, v_gt = d["prj_valid"], d["cam_valid"]
                else:
                    def apply_fn(x, _n=net, _s=scene):
                        return _n(x, _s)
                    v_in, v_gt = d["cam_valid"], d["prj_valid"]
                evaluator = make_evaluator(apply_fn, as_uint8_wire(v_in),
                                           as_uint8_wire(v_gt), dev)
                psnr, rmse, ssim = evaluator()[:3]
                print(f"{j['setup']}: valid PSNR {psnr:.2f} "
                      f"RMSE {rmse:.4f} SSIM {ssim:.4f}")
                rows.append(dict(setup=j["setup"], status="trained",
                                 PSNR=psnr, RMSE=rmse, SSIM=ssim))
    return rows


def spaa_attack_multi_setup(pcnet_applies, logits_fn: Callable, clf_params,
                            cam_scenes, prj_inits, target_idx, targeted,
                            weights, d_thr, mesh: Mesh, axis: str = "setup",
                            cfg=None):
    """S setups' SPAA sweeps as one wave, one setup per device, each device
    running the unmodified production ``attack.spaa.spaa_attack_batched``
    on its own setup in its own host thread (the reference and the
    sequential driver run setups one after the other,
    ``projector_based_attack.py:24-209``).

    Two differences from ``spaa_tpu``'s signature: the port's
    ``make_pcnet_fn`` returns a closure, so ``pcnet_applies`` holds one
    ``pcnet_apply(prj) -> cam`` per setup, already on its device, in
    place of ``(pcnet_apply, pcnet_states)``; and ``clf_params`` (e.g. the
    classifier's net) is replicated, one copy per device, and called as
    ``logits_fn(clf_params, cam)``.

    cam_scenes [S, 1, H, W, 3], prj_inits [S, B, hp, wp, 3], target_idx
    [S, B], targeted [S, B], weights [S, B, 3], d_thr [S, B]: per-setup
    stacks of the production per-config arrays.

    Requires S == mesh size (chunk callers into waves). Returns
    (cam_infer_best [S, B, ...], prj_adv_best [S, B, ...]), stacked on the
    host, where the PNG writers read them."""
    from spaa_tpu_torch.attack.spaa import SpaaConfig, spaa_attack_batched
    if cfg is None:
        cfg = SpaaConfig()
    S = len(pcnet_applies)
    if S != mesh.size:
        raise ValueError(f"{S} setups != {mesh.size}-device mesh "
                         "(chunk into waves of mesh-size setups)")
    clfs = replicate(clf_params, mesh)

    def run(dev, pcnet_apply, clf, scene, prj, tgt, tgd, w, dt):
        def t(a, dtype=None):
            a = _tensor(a, dev)
            return a if dtype is None else a.to(dtype)
        scene = t(scene)
        fdt = scene.dtype
        return spaa_attack_batched(
            pcnet_apply, lambda im: logits_fn(clf, im), scene, t(prj, fdt),
            t(tgt, torch.long), t(tgd, torch.bool), t(w, fdt), t(dt, fdt),
            cfg)

    outs = _per_device(run, mesh.devices, pcnet_applies, clfs, cam_scenes,
                       prj_inits, target_idx, targeted, weights, d_thr)
    return (torch.stack([o[0].detach().cpu() for o in outs]),
            torch.stack([o[1].detach().cpu() for o in outs]))


def percal_attack_multi_setup(compen_apply: Callable, logits_fn: Callable,
                              compen_params_list, clf_params, cam_scenes,
                              target_idx, targeted, d_thr, mesh: Mesh,
                              axis: str = "setup", cfg=None):
    """S setups' PerC-AL+CompenNet++ attacks as one wave, one setup per
    device: the production loop (``attack.perc_al.perc_al_core``, projector
    variant) on the setup's scene batch, then its CompenNet++ compensates
    the adversarial camera images into projector inputs (sequential
    reference: ``projector_based_attack.py:342-359`` per setup).

    compen_apply(params, cam [B, ...], scene [B, ...]) -> prj, with
    ``params`` one entry of ``compen_params_list`` (S entries, e.g. the
    CompenNet++ modules), moved to its setup's device. As in
    :func:`spaa_attack_multi_setup`, ``clf_params`` is replicated and
    called as ``logits_fn(clf_params, cam)``. cam_scenes [S, 1, H, W, 3];
    target_idx, targeted, d_thr [S, B].

    Requires S == mesh size. Returns (cam_infer_best [S, B, ...],
    prj_adv_best [S, B, ...]), stacked on the host."""
    from spaa_tpu_torch.attack.perc_al import PercALConfig, perc_al_core
    if cfg is None:
        cfg = PercALConfig()
    S = len(compen_params_list)
    if S != mesh.size:
        raise ValueError(f"{S} setups != {mesh.size}-device mesh "
                         "(chunk into waves of mesh-size setups)")
    clfs = replicate(clf_params, mesh)

    def run(dev, cp, clf, scene, tgt, tgd, dt):
        scene = _tensor(scene, dev)
        b = len(tgt)
        scene_b = scene.expand(b, *scene.shape[1:])
        x_best = perc_al_core(
            lambda im: logits_fn(clf, im), scene_b,
            _tensor(tgt, dev).to(torch.long), _tensor(tgd, dev).to(torch.bool),
            cfg, d_thr=_tensor(dt, dev).to(scene.dtype),
            projector_variant=True)
        with torch.no_grad():
            prj = compen_apply(_tree_map(lambda x: _to(x, dev), cp), x_best,
                               scene_b)
        return x_best, prj

    outs = _per_device(run, mesh.devices, compen_params_list, clfs,
                       cam_scenes, target_idx, targeted, d_thr)
    return (torch.stack([o[0].detach().cpu() for o in outs]),
            torch.stack([o[1].detach().cpu() for o in outs]))


def _on_device(trained, dev: torch.device):
    """A ``TrainedModel`` with its model and constants on ``dev``."""
    if trained.cam_scene.device == dev:
        return trained
    return dataclasses.replace(
        trained, model=copy.deepcopy(trained.model).to(dev),
        mask=None if trained.mask is None else trained.mask.to(dev),
        cam_scene=trained.cam_scene.to(dev))


def _wave_logits_fn(classifier, cp_sz, compute_dtype):
    """``(logits_fn(net, im), net)`` for the wave primitives:
    ``make_attack_logits_fn``'s pipeline with the net as an argument, so
    that each device calls its own replica."""
    from spaa_tpu_torch.models.classifiers import make_logits_fn
    net = classifier.net
    if compute_dtype and getattr(torch, compute_dtype) != \
            next(net.parameters()).dtype:
        net = copy.deepcopy(net).to(getattr(torch, compute_dtype))

    def logits_fn(net, im):
        cdtype = next(net.parameters()).dtype
        return make_logits_fn(net, cp_sz)(im.to(cdtype)).to(im.dtype)

    return logits_fn, net


def _prep_setups(cfg, dev):
    """Each setup's scene and trained (or, with ``cfg.load_pretrained``,
    loaded) model, prepared as the sequential driver prepares them."""
    from spaa_tpu_torch.attack import orchestrate as O
    prepped = []
    for setup_name in cfg.setup_list:
        path, info, cp_sz, scene = O.load_attack_setup(cfg.data_root,
                                                       setup_name, dev)
        prepped.append(dict(name=setup_name, path=path, info=info,
                            scene=scene, cp_sz=cp_sz,
                            trained=O.train_attacker_model(cfg, setup_name,
                                                           dev),
                            key=(tuple(scene.shape),
                                 tuple(info["prj_im_sz"]), cp_sz)))
    return prepped


def _waves(prepped, wave_sz: int):
    """Setups grouped by shape key, then cut into waves of ``wave_sz``."""
    groups: dict = {}
    for pr in prepped:
        groups.setdefault(pr["key"], []).append(pr)
    for group in groups.values():
        for lo in range(0, len(group), wave_sz):
            yield group[lo:lo + wave_sz]


def run_spaa_attack_multi_setup(cfg, mesh="auto", weights_dir=None,
                                device=None):
    """The SPAA sweeps over ``cfg.setup_list``, mesh-size setups at a time:
    the driver around :func:`spaa_attack_multi_setup`, writing the same
    directory layout and PNGs as the sequential driver
    (``attack.orchestrate.run_projector_based_attack``, ref
    ``projector_based_attack.py:24-148``).

    Per-setup PCNet training or loading stays sequential (fill the cache
    with :func:`pretrain_pcnets_multi_setup` / ``--multi-setup-train``
    first, then run this with ``cfg.load_pretrained``). Setups are grouped
    by shape and cut into waves of the mesh size; a wave of one runs the
    sequential driver's own program, and a remainder wave a sub-mesh of
    its size. On one device (``mesh="auto"`` with one card) every wave is
    a wave of one. Each setup warps through the fixed-grid kernel
    (``make_pcnet_fn``)."""
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.models.classifiers import Classifier
    from spaa_tpu_torch.utils.seed import reset_rng_seeds

    assert cfg.attacker_name == "SPAA", \
        "multi-setup attack waves are implemented for SPAA"
    mesh, dev = _placement(mesh, device)
    reset_rng_seeds(0)
    wave_sz = mesh.size if mesh is not None else 1
    compute_dtype = cfg.get("attack_dtype")
    attacker_cfg_str = O.to_attacker_cfg_str("SPAA")[0]
    prepped = _prep_setups(cfg, dev)
    imagenet_labels, target_idx = O.attack_labels(cfg.data_root)

    for classifier_name in cfg.classifier_names:
        classifier = Classifier(classifier_name, weights_dir,
                                sort_results=True, device=dev)
        for wave in _waves(prepped, wave_sz):
            cp_sz = wave[0]["cp_sz"]
            per_setup = []
            for pr in wave:
                _, _, pred_idx = classifier(pr["scene"], cp_sz)
                true_idx = int(pred_idx[0, 0])
                print(f"  [SPAA multi-setup] {pr['name']} vs "
                      f"{classifier_name}: original class "
                      f"{imagenet_labels[true_idx]}")
                if len(wave) == 1:
                    # a wave of one: the sequential program
                    O._run_spaa_sweep(cfg, pr["trained"], classifier,
                                      pr["scene"], target_idx, true_idx,
                                      pr["info"], pr["path"],
                                      attacker_cfg_str, classifier_name)
                else:
                    per_setup.append(O.build_spaa_sweep_arrays(
                        cfg, pr["info"], target_idx, true_idx))
            if len(wave) > 1:
                wv_mesh = Mesh(mesh.devices[:len(wave)], mesh.axis)
                configs, per_cfg, spaa_cfg = (per_setup[0][0],
                                              per_setup[0][1],
                                              per_setup[0][7])
                stk = [np.stack([ps[i] for ps in per_setup])
                       for i in range(2, 7)]
                logits_fn, net = _wave_logits_fn(classifier, cp_sz,
                                                 compute_dtype)
                applies = [O.make_pcnet_fn(_on_device(pr["trained"], d),
                                           compute_dtype=compute_dtype)
                           for pr, d in zip(wave, wv_mesh.devices)]
                cam_ms, prj_ms = spaa_attack_multi_setup(
                    applies, logits_fn, net,
                    [pr["scene"] for pr in wave], *stk, mesh=wv_mesh,
                    cfg=spaa_cfg)
                for s, pr in enumerate(wave):
                    O.save_spaa_sweep_outputs(
                        cam_ms[s], prj_ms[s], configs, per_cfg, pr["path"],
                        attacker_cfg_str, classifier_name)
            print(f"  [SPAA multi-setup] wave of {len(wave)} setups done "
                  f"({classifier_name})")
    return cfg


def run_percal_attack_multi_setup(cfg, mesh="auto", weights_dir=None,
                                  device=None):
    """PerC-AL+CompenNet++ twin of :func:`run_spaa_attack_multi_setup`: the
    PerC-AL attacks over ``cfg.setup_list``, mesh-size setups per wave,
    saved as the sequential driver saves them
    (``attack.orchestrate._run_percal_sweep``). CompenNet++ training or
    loading stays sequential (fill the cache with
    :func:`pretrain_compennets_pp_multi_setup` first)."""
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.attack.perc_al import PercALConfig
    from spaa_tpu_torch.models.classifiers import Classifier
    from spaa_tpu_torch.utils.io import save_imgs
    from spaa_tpu_torch.utils.seed import reset_rng_seeds

    assert cfg.attacker_name == "PerC-AL+CompenNet++"
    mesh, dev = _placement(mesh, device)
    reset_rng_seeds(0)
    wave_sz = mesh.size if mesh is not None else 1
    attacker_cfg_str = O.to_attacker_cfg_str("PerC-AL+CompenNet++")[0]
    prepped = _prep_setups(cfg, dev)
    imagenet_labels, target_idx = O.attack_labels(cfg.data_root)
    n = len(target_idx)
    attack_iters = int(cfg.get("attack_iters", 50))
    pcfg = PercALConfig(max_iterations=attack_iters, alpha_l_init=1.0,
                        alpha_c_init=0.5, confidence=40)

    for classifier_name in cfg.classifier_names:
        classifier = Classifier(classifier_name, weights_dir,
                                sort_results=True, device=dev)
        for wave in _waves(prepped, wave_sz):
            cp_sz = wave[0]["cp_sz"]
            tgt = np.zeros((len(wave), n + 1), np.int64)
            for s, pr in enumerate(wave):
                _, _, pred_idx = classifier(pr["scene"], cp_sz)
                tgt[s, :n] = target_idx
                tgt[s, n] = int(pred_idx[0, 0])
            if len(wave) == 1:
                # a wave of one: the sequential program
                pr = wave[0]
                O._run_percal_sweep(cfg, pr["trained"], classifier,
                                    pr["scene"], target_idx, int(tgt[0, n]),
                                    pr["info"], pr["path"], attacker_cfg_str,
                                    classifier_name, imagenet_labels)
            else:
                wv_mesh = Mesh(mesh.devices[:len(wave)], mesh.axis)
                logits_fn, net = _wave_logits_fn(classifier, cp_sz, None)
                targeted = np.tile(np.asarray([True] * n + [False]),
                                   (len(wave), 1))
                for stealth_loss in cfg.stealth_losses:
                    for d_thr in cfg.d_threshes:
                        cam_ms, prj_ms = percal_attack_multi_setup(
                            lambda m, cam, scene: m(cam, scene), logits_fn,
                            [pr["trained"].model for pr in wave], net,
                            [pr["scene"] for pr in wave], tgt, targeted,
                            np.full((len(wave), n + 1), float(d_thr)),
                            mesh=wv_mesh, cfg=pcfg)
                        folder = join(attacker_cfg_str, stealth_loss,
                                      str(d_thr), classifier_name)
                        for s, pr in enumerate(wave):
                            save_imgs(cam_ms[s].numpy(), join(
                                pr["path"], "cam/infer/adv", folder))
                            save_imgs(prj_ms[s].numpy(), join(
                                pr["path"], "prj/adv", folder))
            print(f"  [PerC-AL multi-setup] wave of {len(wave)} setups done "
                  f"({classifier_name})")
    return cfg
