"""Benchmark stats: per-setup tables, result montages and the cross-setup
pivot table (counterpart of ``spaa_tpu/attack/summarize.py``, reference
``projector_based_attack.py:362-614``).

The same 71 columns (11 key and success-rate columns, 6 validation
metrics, then 6 metrics x {prj, infer, real} x {targeted, untargeted,
all}), the same success-rate definitions and the same pivot layout (paper
Table 1). Classification, the validation bundle and the stealth metrics
run on the device; PNG decoding, montage drawing and PNG encoding on the
host, the montages in a thread pool shared across setups.
"""

from __future__ import annotations

import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from typing import Optional

import numpy as np
import torch

from spaa_tpu_torch.attack.orchestrate import to_attacker_cfg_str
from spaa_tpu_torch.models.classifiers import Classifier, load_imagenet_labels
from spaa_tpu_torch.ops.image import center_crop, resize_area
from spaa_tpu_torch.ops.metrics import (dists_from_per_sample,
                                        metrics_tensors, per_sample_img_dists)
from spaa_tpu_torch.train.data import load_setup_info
from spaa_tpu_torch.utils.device import resolve_device
from spaa_tpu_torch.utils.imgproc_host import (insert_texts, make_grid,
                                               resize_area_np, to_pseudocolor)
from spaa_tpu_torch.utils.io import imread, imread_dir, save_imgs
from spaa_tpu_torch.utils.table import Table, concat, read_csv
from spaa_tpu_torch.utils.xlsx import to_excel

PHASES = ["Valid", "prj", "infer", "real"]
METRICS = ["PSNR", "RMSE", "SSIM", "L2", "Linf", "dE"]
COLUMNS = (["Setup", "Attacker", "Stealth_loss", "d_thr", "Classifier",
            "T.top-1_infer", "T.top-5_infer", "T.top-1_real",
            "T.top-5_real", "U.top-1_infer", "U.top-1_real"]
           + [PHASES[0] + "_" + y for y in METRICS]
           + ["T." + x + "_" + y for x in PHASES[1:] for y in METRICS]
           + ["U." + x + "_" + y for x in PHASES[1:] for y in METRICS]
           + ["All." + x + "_" + y for x in PHASES[1:] for y in METRICS])
PIVOT_VALUES = ["T.top-1_real", "T.top-5_real", "U.top-1_real", "T.real_L2",
                "T.real_Linf", "T.real_dE", "T.real_SSIM", "All.real_L2",
                "All.real_Linf", "All.real_dE", "All.real_SSIM"]
PIVOT_INDEX = ["Attacker", "d_thr", "Stealth_loss", "Classifier"]
METRICS_CHUNK = 64     # images per stealth-metrics pass on the device
_MAX_PENDING_RENDERS = 48


def _f01(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


def valid_metrics(x_u8, y_u8, device) -> list:
    """The validation bundle (PSNR, RMSE, SSIM, L2, L-inf, deltaE) of
    uint8 stacks, computed on ``device``."""
    with torch.no_grad():
        vals = metrics_tensors(_f01(torch.from_numpy(x_u8).to(device)),
                               _f01(torch.from_numpy(y_u8).to(device)))
    return [float(v) for v in vals]


def stealth_metrics(pa, gray, ci, cr, cs) -> list:
    """The 15 per-sample arrays (5 primitives x prj/infer/real pairs) of a
    whole image stack, on the stacks' device, ``METRICS_CHUNK`` images a
    pass (each sample's values depend on that sample only). ``pa``, ``ci``
    and ``cr`` may be uint8; ``gray`` [1, ...] and ``cs`` [1, ...] are
    broadcast."""
    parts = []
    with torch.no_grad():
        for s in range(0, pa.shape[0], METRICS_CHUNK):
            sl = slice(s, s + METRICS_CHUNK)
            p, i, r = _f01(pa[sl]), _f01(ci[sl]), _f01(cr[sl])
            parts.append(per_sample_img_dists(p, gray.expand_as(p))
                         + per_sample_img_dists(i, cs.expand_as(i))
                         + per_sample_img_dists(r, cs.expand_as(r)))
    return [torch.cat([p[k] for p in parts]).cpu().numpy()
            for k in range(15)]


def montage_panels(cam_scene, cam_infer, cam_real, prj_adv, im_gray,
                   cp_sz, prj_im_sz, device=None):
    """One cell's montage panels on the device: crops, 'area' resizes to
    the projector size and the per-target L2 annotations; numpy out."""
    dev = resolve_device(device)
    prj_hw = (int(prj_im_sz[1]), int(prj_im_sz[0]))

    def t(x):
        return _f01(torch.as_tensor(np.asarray(x)).to(dev))

    with torch.no_grad():
        scene_cp = center_crop(t(cam_scene), cp_sz)
        infer_cp = center_crop(t(cam_infer), cp_sz)
        real_cp = center_crop(t(cam_real), cp_sz)
        prj_adv, im_gray = t(prj_adv), t(im_gray)

        def per_sample_l2(x, y):
            return torch.mean(torch.linalg.norm(x - y.expand_as(x), dim=-1),
                              dim=(1, 2)) * 255.0

        out = (resize_area(scene_cp, prj_hw)[0], resize_area(infer_cp, prj_hw),
               resize_area(real_cp, prj_hw), per_sample_l2(prj_adv, im_gray),
               per_sample_l2(infer_cp, scene_cp),
               per_sample_l2(real_cp, scene_cp))
    return tuple(o.cpu().numpy() for o in out)


def attack_results(ret, t, imgnet_labels, prj_adv, prj_im_sz,
                   panels) -> np.ndarray:
    """Five-panel annotated uint8 result montage for target ``t`` (ref
    ``projector_based_attack.py:362-414``). ``panels``: the whole cell's
    (scene, infer, real) panels resized to the projector size and its
    three per-target L2 arrays, as :func:`montage_panels` returns them
    (summarize resizes on the host)."""
    prj_hw = (int(prj_im_sz[1]), int(prj_im_sz[0]))
    scene_rz, infer_all, real_all, prj_l2s, pred_l2s, real_l2s = panels
    real_rz = real_all[t]
    infer_rz = infer_all[t]

    diff = np.abs(real_rz - scene_rz)
    diff = (diff - diff.min()) / max(diff.max() - diff.min(), 1e-12)
    diff_color = to_pseudocolor(diff.mean(-1))

    def u8(x):
        x = np.asarray(x)
        return x if x.dtype == np.uint8 else np.uint8(np.clip(x, 0, 1) * 255)

    im = make_grid(np.stack([u8(scene_rz), u8(prj_adv[t]), u8(infer_rz),
                             u8(real_rz), u8(diff_color)], 0),
                   nrow=5, padding=5, pad_value=255)

    prj_l2 = float(prj_l2s[t])
    pred_l2 = float(pred_l2s[t])
    real_l2 = float(real_l2s[t])

    # the reference places labels for 256-px panels (261-px pitch); other
    # projector sizes scale x, as spaa_tpu does
    sx = (prj_hw[1] + 5) / 261.0
    fsz = max(int(round(14 * prj_hw[1] / 256.0)), 8)
    row2 = fsz
    black = (0, 0, 0)

    def at(x, y):
        return (int(round(x * sx)), y)

    labels = [
        (f"Cam-captured scene ({t})", at(70, 0), black),
        (f"{imgnet_labels[int(ret['scene'][2][0, 0])]} "
         f"({ret['scene'][1][0, 0]:.2f})", at(5, row2), black),
        ("Model inferred adversarial projection", at(280, 0), black),
        (f"L2={prj_l2:.2f}", at(370, row2), black),
        ("Model inferred cam-captured projection", at(530, 0), black),
        (f"{imgnet_labels[int(ret['infer'][2][t, 0])]} "
         f"({ret['infer'][1][t, 0]:.2f})", at(530, row2), black),
        (f"L2={pred_l2:.2f}", at(720, row2), black),
        ("Real cam-captured projection", at(820, 0), black),
        (f"{imgnet_labels[int(ret['real'][2][t, 0])]} "
         f"({ret['real'][1][t, 0]:.2f})", at(790, row2), black),
        (f"L2={real_l2:.2f}", at(980, row2), black),
        ("Normalized difference, i.e., 4th-1st", at(1070, 0), black),
    ]
    return insert_texts(
        im, labels, fsz,
        border=(0, max(int(round(26 * prj_hw[1] / 256.0)), 12), 0, 0),
        as_uint8=True)


def _write_stats_txt(table: Table, ret_path: str) -> None:
    os.makedirs(ret_path, exist_ok=True)
    path = join(ret_path, "stats.txt")
    if len(table) == 0 and os.path.exists(path):
        try:
            old_rows = len(read_csv(path, sep="\t"))
        except Exception:
            old_rows = 0
        if old_rows:
            print(f"WARNING: overwriting {path} ({old_rows} rows) with an "
                  "EMPTY stats table - every result cell of this attacker "
                  "is missing or incomplete (reference semantics: stats "
                  "reflect the current result folders)")
    table.to_csv(path, sep="\t", float_format="%.4f")


def _valid_block(attacker_name, setup_path, data_root, model_cfg_str, cp_sz,
                 dev) -> list:
    """Validation metrics of the attacker's surrogate (ref :463-473);
    zeros where it has none."""
    if attacker_name == "SPAA":
        inf_dir = join(setup_path, "cam/infer/test", model_cfg_str)
        if os.path.isdir(inf_dir):
            return valid_metrics(
                np.ascontiguousarray(center_crop(
                    imread_dir(inf_dir, as_uint8=True), cp_sz)),
                np.ascontiguousarray(center_crop(
                    imread_dir(join(setup_path, "cam/raw/test"),
                               as_uint8=True), cp_sz)), dev)
    elif attacker_name == "PerC-AL+CompenNet++":
        inf_dir = join(setup_path, "prj/infer/test", model_cfg_str)
        if os.path.isdir(inf_dir):
            im_infer = imread_dir(inf_dir, as_uint8=True)
            im_gt = imread_dir(join(data_root, "prj_share/test"),
                               index=list(range(im_infer.shape[0])),
                               as_uint8=True)
            return valid_metrics(im_infer, im_gt, dev)
    return [0] * 6


def summarize_single_attacker(attacker_name: str, data_root: str, setup_list,
                              weights_dir: Optional[str] = None,
                              stealth_losses=None, d_threshes=None,
                              classifier_names=None,
                              recreate_imgs: bool = True,
                              device=None) -> Table:
    """Per-setup stats table and montages (ref
    ``projector_based_attack.py:417-574``). The full (stealth x d_thr x
    classifier) grid, '-' rows included, is scanned; a (loss, d_thr) row
    stops at its first missing classifier, with a notice. Each setup gets
    a fresh table, written to its ``ret/<attacker>/stats.txt`` and
    ``stats.xlsx``; the setups' tables are returned concatenated.

    ``recreate_imgs=False`` recomputes every row but skips montages of
    cells whose ``ret/`` directory already holds all images."""
    assert attacker_name in ["SPAA", "PerC-AL+CompenNet++", "One-pixel_DE"]
    dev = resolve_device(device)
    attacker_cfg_str, model_cfg_str = to_attacker_cfg_str(attacker_name)
    dl_based = attacker_name in ["SPAA", "PerC-AL+CompenNet++"]

    imagenet_labels = load_imagenet_labels(
        join(data_root, "imagenet1000_clsidx_to_labels.txt"))
    target_labels = load_imagenet_labels(
        join(data_root, "imagenet10_clsidx_to_labels.txt"))
    n = 10
    target_labels = dict(itertools.islice(target_labels.items(), n))
    target_idx = list(target_labels.keys())

    stealth_losses = stealth_losses or ["caml2", "camdE", "camdE_caml2", "-"]
    d_threshes = d_threshes or [5, 7, 9, 11, "-"]
    classifier_names = classifier_names or ["inception_v3", "resnet18",
                                            "vgg16"]

    # montages are host work with no effect on the tables: one pool for
    # all setups, so setup k's renders drain while setup k+1's device
    # phases run
    pool = ThreadPoolExecutor(max_workers=min(8, max(os.cpu_count() or 1, 2)))
    futures = []
    setup_tables = []
    try:
        for setup_name in setup_list:
            table = Table(COLUMNS)
            setup_tables.append(table)
            setup_path = join(data_root, "setups", setup_name)
            print(f"\nCalculating stats of [{attacker_name}] on [{setup_path}]")
            setup_info = load_setup_info(setup_path)
            cp_sz = tuple(int(c) for c in setup_info["classifier_crop_sz"])
            pw, ph = setup_info["prj_im_sz"]
            im_gray = np.full((1, ph, pw, 3),
                              float(setup_info["prj_brightness"]), np.float32)
            cam_scene = imread(join(setup_path, "cam/raw/ref/img_0002.png"))[None]

            phase_t = {"valid": 0.0, "io": 0.0, "stage": 0.0, "build": 0.0,
                       "classify": 0.0, "metrics": 0.0, "panels": 0.0,
                       "rows": 0.0}
            t0 = time.time()
            valid_ret = _valid_block(attacker_name, setup_path, data_root,
                                     model_cfg_str, cp_sz, dev)
            phase_t["valid"] = time.time() - t0

            # ---- pass 1: result cells, read as uint8 on the host
            t0 = time.time()
            cells = []
            for stealth_loss in stealth_losses:
                for d_thr in d_threshes:
                    for classifier_name in classifier_names:
                        folder = join(attacker_cfg_str, stealth_loss,
                                      str(d_thr), classifier_name)
                        prj_adv_path = join(setup_path, "prj/adv", folder)
                        cam_infer_path = join(setup_path, "cam/infer/adv",
                                              folder)
                        cam_real_path = join(setup_path, "cam/raw/adv", folder)
                        dirs = [prj_adv_path, cam_real_path]
                        if dl_based:
                            dirs.append(cam_infer_path)
                        if any(not os.path.isdir(d) or not os.listdir(d)
                               for d in dirs):
                            print(f"No such folder/images: {folder} - "
                                  "skipping")
                            break
                        cam_real = imread_dir(cam_real_path, as_uint8=True)
                        prj_adv = imread_dir(prj_adv_path, as_uint8=True)
                        cam_infer = (imread_dir(cam_infer_path, as_uint8=True)
                                     if dl_based else cam_real)
                        cells.append(dict(
                            stealth_loss=stealth_loss, d_thr=d_thr,
                            classifier_name=classifier_name, folder=folder,
                            prj_adv=prj_adv, cam_infer=cam_infer,
                            cam_real=cam_real))

            ret_path = join(setup_path, "ret", attacker_cfg_str)
            if not cells:
                print(f"\n---- [{attacker_name}] results on [{setup_name}] ----")
                print(table.to_string())
                _write_stats_txt(table, ret_path)
                continue
            phase_t["io"] = time.time() - t0

            # ---- pass 1.5: one upload per image-stack kind
            t0 = time.time()
            m = n + 1  # images per cell (10 targeted + 1 untargeted)
            complete = [c["prj_adv"].shape[0] == m and c["cam_real"].shape[0]
                        == m and c["cam_infer"].shape[0] == m for c in cells]
            for c, is_ok in zip(cells, complete):
                if not is_ok:
                    print(f"Incomplete result cell (expected {m} images): "
                          f"{c['folder']} - skipping")
            cells = [c for c, is_ok in zip(cells, complete) if is_ok]
            if not cells:
                _write_stats_txt(table, ret_path)
                continue
            # every consumer of the camera stacks crops to cp_sz first:
            # crop on the host and upload only the crop
            ci_host = np.ascontiguousarray(center_crop(
                np.concatenate([c["cam_infer"] for c in cells]), cp_sz))
            cr_host = np.ascontiguousarray(center_crop(
                np.concatenate([c["cam_real"] for c in cells]), cp_sz))
            pa_all = torch.from_numpy(
                np.concatenate([c["prj_adv"] for c in cells])).to(dev)
            ci_all = torch.from_numpy(ci_host).to(dev)
            cr_all = torch.from_numpy(cr_host).to(dev)
            cam_scene_u8 = np.uint8(np.round(np.asarray(cam_scene) * 255.0))
            scene_dev = torch.from_numpy(np.ascontiguousarray(
                center_crop(cam_scene_u8, cp_sz))).to(dev)
            phase_t["stage"] = time.time() - t0

            # ---- pass 2: one classification stack per classifier; building
            # the networks is timed apart from their forward passes
            for classifier_name in classifier_names:
                idxs = [i for i, c in enumerate(cells)
                        if c["classifier_name"] == classifier_name]
                if not idxs:
                    continue
                t0 = time.time()
                clf = Classifier(classifier_name, weights_dir,
                                 sort_results=True, device=dev)
                phase_t["build"] += time.time() - t0
                t0 = time.time()
                stack = torch.cat(
                    [scene_dev] + [a for i in idxs
                                   for a in (ci_all[i * m:(i + 1) * m],
                                             cr_all[i * m:(i + 1) * m])], 0)
                _, p_all, idx_all = clf(stack, cp_sz)
                scene_ret = (None, p_all[:1], idx_all[:1])
                for k, i in enumerate(idxs):
                    ofs = 1 + 2 * m * k
                    cells[i]["ret"] = {
                        "scene": scene_ret,
                        "infer": (None, p_all[ofs:ofs + m],
                                  idx_all[ofs:ofs + m]),
                        "real": (None, p_all[ofs + m:ofs + 2 * m],
                                 idx_all[ofs + m:ofs + 2 * m])}
                del clf, stack
                phase_t["classify"] += time.time() - t0

            # ---- pass 2.5: every cell's stealth metrics on the device
            t0 = time.time()
            cs = center_crop(torch.from_numpy(cam_scene).to(dev), cp_sz)
            all_vals = stealth_metrics(pa_all, torch.from_numpy(im_gray).to(dev),
                                       ci_all, cr_all, cs)   # 15 x [C*m]
            del pa_all, ci_all, cr_all, scene_dev
            phase_t["metrics"] = time.time() - t0

            # ---- pass 2.6: the montages' scene panel (host)
            t0 = time.time()
            prj_hw = (int(setup_info["prj_im_sz"][1]),
                      int(setup_info["prj_im_sz"][0]))

            def _montages_exist(c):
                ret_dir = join(setup_path, "ret", c["folder"])
                return (os.path.isdir(ret_dir)
                        and len([f for f in os.listdir(ret_dir)
                                 if f.endswith(".png")]) >= m)

            need_montage = [recreate_imgs or not _montages_exist(c)
                            for c in cells]
            scene_rz = None
            if any(need_montage):
                scene_rz = resize_area_np(
                    center_crop(np.asarray(cam_scene, np.float32), cp_sz),
                    prj_hw)[0]
            phase_t["panels"] = time.time() - t0

            # ---- pass 3: stats rows; montages in the pool
            t0 = time.time()
            for k, c in enumerate(cells):
                ret = c["ret"]
                sl_cell = slice(k * m, (k + 1) * m)
                cell_vals = [v[sl_cell] for v in all_vals]
                prj_vals, infer_vals, real_vals = (cell_vals[0:5],
                                                   cell_vals[5:10],
                                                   cell_vals[10:15])
                if need_montage[k]:
                    # every per-setup value is bound as a default: renders
                    # outlive this iteration (the pool spans setups)
                    def render(ret=ret, prj_adv=c["prj_adv"],
                               ci=ci_host[sl_cell], cr=cr_host[sl_cell],
                               l2s=(prj_vals[2], infer_vals[2], real_vals[2]),
                               folder=c["folder"], scene_rz=scene_rz,
                               prj_hw=prj_hw, m=m,
                               prj_im_sz=tuple(setup_info["prj_im_sz"]),
                               out_dir=join(setup_path, "ret")):
                        infer_rz = resize_area_np(
                            ci.astype(np.float32) / 255.0, prj_hw)
                        real_rz = resize_area_np(
                            cr.astype(np.float32) / 255.0, prj_hw)
                        panels = (scene_rz, infer_rz, real_rz, *l2s)
                        montage = [attack_results(ret, t, imagenet_labels,
                                                  prj_adv, prj_im_sz, panels)
                                   for t in range(m)]
                        save_imgs(np.stack(montage, 0), join(out_dir, folder))

                    # back-pressure: each render pins its setup's stacks,
                    # so wait on the one submitted _MAX_PENDING_RENDERS ago
                    if len(futures) >= _MAX_PENDING_RENDERS:
                        futures[-_MAX_PENDING_RENDERS].result()
                    futures.append(pool.submit(render))

                # success rates (ref :521-533)
                t1_infer = np.count_nonzero(
                    ret["infer"][2][:n, 0] == target_idx) / n
                t5_infer = np.count_nonzero(
                    [target_idx[i] in ret["infer"][2][i, :5]
                     for i in range(n)]) / n
                t1_real = np.count_nonzero(
                    ret["real"][2][:n, 0] == target_idx) / n
                t5_real = np.count_nonzero(
                    [target_idx[i] in ret["real"][2][i, :5]
                     for i in range(n)]) / n
                true_i = ret["scene"][2][0, 0]
                t1_untar_infer = int(ret["infer"][2][n, 0] != true_i)
                t1_untar_real = int(ret["real"][2][n, 0] != true_i)

                def stealth_block(sl):
                    return (list(dists_from_per_sample(prj_vals, sl))
                            + list(dists_from_per_sample(infer_vals, sl))
                            + list(dists_from_per_sample(real_vals, sl)))

                table.append([
                    setup_name, attacker_cfg_str, c["stealth_loss"],
                    c["d_thr"], c["classifier_name"], t1_infer, t5_infer,
                    t1_real, t5_real, t1_untar_infer, t1_untar_real,
                    *valid_ret,
                    *stealth_block(slice(0, n)),        # targeted
                    *stealth_block(slice(n, n + 1)),    # untargeted
                    *stealth_block(slice(0, n + 1)),    # all
                ])
            phase_t["rows"] = time.time() - t0
            print("[summarize] " + " ".join(f"{k}={v:.3f}s"
                                            for k, v in phase_t.items())
                  + f" (montages pending: {sum(not f.done() for f in futures)})")

            print(f"\n---- [{attacker_name}] results on [{setup_name}] ----")
            print(table.to_string())
            _write_stats_txt(table, ret_path)
            to_excel(table, join(ret_path, "stats.xlsx"), index=False)
        # drain the montage renders (an exception propagates)
        t0 = time.time()
        for f in futures:
            f.result()
        if futures:
            print(f"[summarize] montage drain: {time.time() - t0:.3f}s "
                  f"({len(futures)} cells)")
    finally:
        # on an exception: cancel queued renders, wait out running ones
        pool.shutdown(wait=True, cancel_futures=True)
    # every processed setup's rows (PARITY.md: the reference returns only
    # the last setup's table; the per-setup files are the same)
    if not setup_tables:
        return Table(COLUMNS)
    return concat(setup_tables)


def summarize_all_attackers(attacker_names, data_root, setup_list,
                            recreate_stats_and_imgs: bool = False,
                            weights_dir: Optional[str] = None,
                            recreate_imgs: bool = True, device=None):
    """Cross-setup gather and pivot table, paper Table 1 / supplementary
    Table 2 (ref ``projector_based_attack.py:577-614``): writes
    ``setups/stats_all.txt``, ``stats_all.xlsx`` and
    ``pivot_table_all.xlsx``; returns ``(table, pivot)``."""
    tables = []
    for setup_name in setup_list:
        setup_path = join(data_root, "setups", setup_name)
        for attacker_name in attacker_names:
            attacker_cfg_str = to_attacker_cfg_str(attacker_name)[0]
            ret_path = join(setup_path, "ret", attacker_cfg_str)
            print(f"\nGathering stats of {ret_path}")
            if recreate_stats_and_imgs:
                summarize_single_attacker(attacker_name, data_root,
                                          [setup_name],
                                          weights_dir=weights_dir,
                                          recreate_imgs=recreate_imgs,
                                          device=device)
            tables.append(read_csv(join(ret_path, "stats.txt"), sep="\t"))

    table = concat(tables)
    pivot = table.pivot_table(PIVOT_VALUES, PIVOT_INDEX)
    pivot = pivot.sort_index(level=[0, 1], ascending=[False, True])

    table.to_csv(join(data_root, "setups/stats_all.txt"), sep="\t",
                 float_format="%.4f")
    to_excel(table, join(data_root, "setups/stats_all.xlsx"), index=False)
    to_excel(pivot, join(data_root, "setups/pivot_table_all.xlsx"),
             index=True)
    return table, pivot
