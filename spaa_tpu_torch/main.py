"""Step-by-step ProCams setup -> capture -> train -> attack -> summarize
workflow on the simulator (counterpart of the root ``main.py``, reference
``main.py``'s interactive cells as one script with ``--steps``).

Steps (reference ``main.py`` cell numbers in parens):
  1 setup            create setup dirs + setup_info.yml            (1)
  2 capture          sync test, then the simulator's captures      (2-3)
  3 check            classifiers must agree on the clean scene     (3)
  4 train            train PCNet on the captured pairs             (4)
  5 attack           run the SPAA attack sweep                     (5.1)
  6 capture-attack   re-project adversarial images, capture real   (5.2)
  7 summarize        SPAA per-setup stats + montages               (5.2)
  8 percal           PerC-AL+CompenNet++: train CompenNet++, attack,
                     replay, summarize                             (6.1-6.2)
  9 one-pixel        One-pixel_DE: attack through the simulator's
                     captures, then summarize                      (7.1)
  10 summarize-all   gather + pivot table of the three attackers,
                     paper Table 1                                 (8)

Runs on ``cuda`` unless ``--device cpu``. ``--hardware`` drives a real
projector and camera (``utils.procams.HardwareProCams``, from the setup's
``setup_info.yml``) in place of the simulator; step 2 then checks the
brightness and pose interactively, runs the sync test and captures the
setup. It needs OpenCV, matplotlib and a camera.

Usage:
  python -m spaa_tpu_torch.main --data-root data --setup-name sim_test \\
      --steps 1-10
  python -m spaa_tpu_torch.main --hardware --data-root data \\
      --setup-name my_object --steps 2 --cam-index 0
"""

from __future__ import annotations

import argparse
import os
import time
from os.path import join


def _parse_steps(spec: str):
    out = set()
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.update(range(int(a), int(b) + 1))
        else:
            out.add(int(part))
    return sorted(out)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--setup-name", default="sim_test")
    ap.add_argument("--steps", default="1-7")
    ap.add_argument("--hardware", action="store_true",
                    help="use a real projector + camera (else: simulator)")
    ap.add_argument("--cam-index", type=int, default=0)
    ap.add_argument("--prj-offset", type=int, nargs=2, default=(1920, 0),
                    help="projector window position (second display)")
    ap.add_argument("--load-pretrained", action="store_true")
    ap.add_argument("--train-iters", type=int, default=None,
                    help="debug/CI: override the model training budgets "
                         "(PCNet, CompenNet++ and CompenNet's pre-training)")
    ap.add_argument("--attack-iters", type=int, default=None,
                    help="debug/CI: override the attack iteration budget")
    ap.add_argument("--classifiers", nargs="*", default=None,
                    help="debug/CI: restrict the classifier zoo")
    ap.add_argument("--stealth-losses", nargs="*", default=None)
    ap.add_argument("--d-threshes", nargs="*", type=int, default=None)
    ap.add_argument("--op-budget", nargs=4, type=int, default=None,
                    metavar=("PIXEL_SIZE", "MAXITER", "POP_U", "POP_T"),
                    help="debug/CI: One-pixel_DE budget overrides")
    ap.add_argument("--sim-size", nargs=4, type=int, default=None,
                    metavar=("PRJ_W", "PRJ_H", "CAM_W", "CAM_H"),
                    help="debug/CI: shrink the simulator image sizes")
    ap.add_argument("--num-train", type=int, default=500,
                    help="simulator training-pair count (step 2)")
    ap.add_argument("--weights-dir", default=None,
                    help="where the pinned classifier .pth files are "
                         "(default: <repo>/checkpoint)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    steps = _parse_steps(args.steps)

    from spaa_tpu_torch.utils.config import (DictConfig, load_flat_yaml,
                                             save_flat_yaml)
    from spaa_tpu_torch.utils.device import resolve_device
    from spaa_tpu_torch.utils.log import print_peak_memory
    from spaa_tpu_torch.utils.seed import reset_rng_seeds
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)

    dev = resolve_device(args.device)
    reset_rng_seeds(0)
    data_root = args.data_root
    setup_name = args.setup_name
    setup_path = join(data_root, "setups", setup_name)

    def _apply_attack_overrides(cfg, grids: bool = False):
        # grids only for SPAA: PerC-AL's (loss, d_thr) grid is fixed
        if args.classifiers:
            cfg.classifier_names = list(args.classifiers)
        if grids and args.stealth_losses:
            cfg.stealth_losses = list(args.stealth_losses)
        if grids and args.d_threshes:
            cfg.d_threshes = list(args.d_threshes)
        if args.attack_iters:
            cfg.attack_iters = int(args.attack_iters)
        if args.train_iters:
            cfg.max_iters = int(args.train_iters)
            cfg.init_max_iters = int(args.train_iters)
        if args.op_budget:
            (cfg.op_pixel_size, cfg.op_maxiter, cfg.op_popsize_untargeted,
             cfg.op_popsize_targeted) = (int(v) for v in args.op_budget)
        return cfg

    summarize_kw = dict(
        classifier_names=list(args.classifiers) if args.classifiers else None,
        stealth_losses=(list(args.stealth_losses) if args.stealth_losses
                        else None),
        d_threshes=list(args.d_threshes) if args.d_threshes else None,
        weights_dir=args.weights_dir, device=dev)

    info_path = join(setup_path, "setup_info.yml")
    if args.hardware:
        from spaa_tpu_torch.utils.procams import HardwareProCams
        if not os.path.exists(info_path):
            raise SystemExit("run --steps 1 first to create setup_info.yml")
        procams = HardwareProCams(load_flat_yaml(info_path),
                                  cam_index=args.cam_index)
    else:
        info = dict(DEFAULT_SIM_SETUP_INFO)
        if args.sim_size:
            pw, ph, cw, ch = (int(v) for v in args.sim_size)
            cp = min(cw, ch)
            info.update(prj_im_sz=[pw, ph], cam_im_sz=[cw, ch],
                        classifier_crop_sz=[cp, cp])
        # an existing setup_info.yml wins: the simulator must capture at
        # the sizes every later step reads back from it
        if os.path.exists(info_path):
            existing = dict(load_flat_yaml(info_path))
            if args.sim_size and any(list(existing.get(k, [])) != info[k]
                                     for k in ("prj_im_sz", "cam_im_sz",
                                               "classifier_crop_sz")):
                print(f"WARNING: --sim-size ignored - existing {info_path} "
                      "wins (delete the setup directory to change sizes)")
            info = existing
        procams = SimProCams(info)

    def step(k, name):
        print(f"\n[step {k}] {name}", flush=True)
        return time.time()

    def done(k, t0):
        print(f"[step {k}] {time.time() - t0:.3f} s", flush=True)

    # ---- 1. setup info + directories (ref main.py:19-33,99)
    if 1 in steps:
        t0 = step(1, "setup")
        from spaa_tpu_torch.utils.io import make_setup_subdirs
        make_setup_subdirs(setup_path)
        if os.path.exists(info_path):
            setup_info = load_flat_yaml(info_path)
            print(f"Loaded existing {info_path}")
        elif not args.hardware:
            setup_info = DictConfig(dict(procams.setup_info))
            save_flat_yaml(setup_info, info_path)
            print(f"Wrote simulator {info_path}")
        else:
            setup_info = DictConfig(dict(
                prj_screen_sz=[800, 600], prj_im_sz=[256, 256],
                prj_offset=list(args.prj_offset), cam_raw_sz=[640, 480],
                cam_crop_sz=[640, 480], cam_im_sz=[320, 240],
                classifier_crop_sz=[240, 240], prj_brightness=0.5,
                delay_frames=10, delay_time=0.02))
            save_flat_yaml(setup_info, info_path)
            print(f"Wrote default {info_path} - edit knobs and re-run")
        print(dict(setup_info))
        done(1, t0)

    # ---- 2. the sync test, then the captures (ref main.py:41-125)
    if 2 in steps:
        t0 = step(2, "capture")
        from spaa_tpu_torch.utils.procams import (
            adjust_setup_brightness_and_pose, capture_setup_data, sync_test)
        if args.hardware:
            # interactive brightness / pose / exposure check (ref
            # main.py:41-50)
            adjust_setup_brightness_and_pose(procams)
            sync_test(procams, data_root)
            capture_setup_data(procams, data_root, setup_name)
        else:
            sync_test(procams, data_root)
            print("[sim] generating synthetic captures for the full setup")
            n_train = int(args.num_train)
            procams.make_setup(data_root, setup_name, num_train=n_train,
                               num_test=max(n_train * 2 // 5, 2))
        done(2, t0)

    # ---- 3. classifiers must agree on the clean scene (ref main.py:128-135)
    if 3 in steps:
        t0 = step(3, "check")
        import torch
        from spaa_tpu_torch.models.classifiers import (
            DEFAULT_WEIGHTS_DIR, load_imagenet_labels, params_source,
            query_multi_classifiers)
        from spaa_tpu_torch.train.data import load_setup_info
        from spaa_tpu_torch.utils.io import imread
        sinfo = load_setup_info(setup_path)
        cam_scene = imread(join(setup_path, "cam/raw/ref/img_0002.png"))
        labels = load_imagenet_labels(
            join(data_root, "imagenet1000_clsidx_to_labels.txt"))
        cp_sz = tuple(int(c) for c in sinfo["classifier_crop_sz"])
        names = (list(args.classifiers) if args.classifiers
                 else ["inception_v3", "resnet18", "vgg16"])
        pred, _ = query_multi_classifiers(
            torch.from_numpy(cam_scene)[None], cp_sz, names, labels,
            weights_dir=args.weights_dir, device=dev)
        if all(params_source(n, args.weights_dir) != "random" for n in names):
            assert len(set(pred)) == 1, \
                "Classifiers disagree on the clean scene - adjust the " \
                "object/camera pose before attacking (ref main.py:135)"
        elif len(set(pred)) != 1:
            print("WARNING: classifiers disagree on the scene (expected "
                  "with random-init weights; drop the pinned torchvision "
                  f".pth files into {args.weights_dir or DEFAULT_WEIGHTS_DIR} "
                  "for parity)")
        done(3, t0)

    # ---- 4. train PCNet (ref main.py:139-146)
    if 4 in steps:
        t0 = step(4, "train")
        from spaa_tpu_torch.train.pipeline import train_eval_pcnet
        from spaa_tpu_torch.train.train import get_model_train_cfg
        cfg = get_model_train_cfg(["PCNet"], data_root, [setup_name],
                                  load_pretrained=args.load_pretrained)
        if args.train_iters:
            cfg.max_iters = int(args.train_iters)
        train_eval_pcnet(cfg, dev)
        done(4, t0)

    from spaa_tpu_torch.attack import (get_attacker_cfg,
                                       project_capture_real_attack,
                                       run_projector_based_attack,
                                       summarize_all_attackers,
                                       summarize_single_attacker)
    # ---- 5. SPAA attack sweep (ref main.py:148-156)
    if 5 in steps:
        t0 = step(5, "attack")
        cfg = _apply_attack_overrides(get_attacker_cfg(
            "SPAA", data_root, [setup_name], load_pretrained=True), grids=True)
        run_projector_based_attack(cfg, weights_dir=args.weights_dir,
                                   device=dev)
        done(5, t0)

    # ---- 6. re-project + capture the adversarial images (ref main.py:158-166)
    if 6 in steps:
        t0 = step(6, "replay")
        cfg = _apply_attack_overrides(get_attacker_cfg("SPAA", data_root,
                                                       [setup_name]),
                                      grids=True)
        project_capture_real_attack(cfg, procams)
        done(6, t0)

    # ---- 7. summarize SPAA (ref main.py:166)
    if 7 in steps:
        t0 = step(7, "summarize")
        df = summarize_single_attacker("SPAA", data_root, [setup_name],
                                       **summarize_kw)
        print(df.head())
        done(7, t0)

    # ---- 8. PerC-AL+CompenNet++: train CompenNet++, attack, replay,
    # summarize (ref main.py:169-196, cells 6.1-6.2)
    if 8 in steps:
        t0 = step(8, "percal")
        # ref main.py:177 trains CompenNet++ afresh; --load-pretrained
        # reuses a cached checkpoint
        cfg = _apply_attack_overrides(get_attacker_cfg(
            "PerC-AL+CompenNet++", data_root, [setup_name],
            load_pretrained=args.load_pretrained))
        cfg = run_projector_based_attack(cfg, weights_dir=args.weights_dir,
                                         device=dev)
        t1 = time.time()
        project_capture_real_attack(cfg, procams)
        t2 = time.time()
        df = summarize_single_attacker(
            "PerC-AL+CompenNet++", data_root, [setup_name],
            classifier_names=summarize_kw["classifier_names"],
            weights_dir=args.weights_dir, device=dev)
        print(df.head())
        print(f"[step 8] train+attack {t1 - t0:.3f} s, replay {t2 - t1:.3f} "
              f"s, summarize {time.time() - t2:.3f} s", flush=True)
        done(8, t0)

    # ---- 9. One-pixel_DE: no training; its adversarial projections are
    # captured while it attacks (ref main.py:198-212, cell 7.1)
    if 9 in steps:
        t0 = step(9, "one-pixel")
        cfg = _apply_attack_overrides(get_attacker_cfg(
            "One-pixel_DE", data_root, [setup_name]))
        run_projector_based_attack(cfg, procams=procams,
                                   weights_dir=args.weights_dir, device=dev)
        t1 = time.time()
        df = summarize_single_attacker(
            "One-pixel_DE", data_root, [setup_name],
            classifier_names=summarize_kw["classifier_names"],
            weights_dir=args.weights_dir, device=dev)
        print(df.head())
        print(f"[step 9] attack {t1 - t0:.3f} s, summarize "
              f"{time.time() - t1:.3f} s", flush=True)
        done(9, t0)

    # ---- 10. gather + pivot table, paper Table 1 (ref main.py:214-225)
    if 10 in steps:
        t0 = step(10, "summarize-all")
        _, pivot_table = summarize_all_attackers(
            ["SPAA", "PerC-AL+CompenNet++", "One-pixel_DE"], data_root,
            [setup_name], recreate_stats_and_imgs=False,
            weights_dir=args.weights_dir, device=dev)
        print(f"\n------ Pivot table of 1 setup in {data_root} ------")
        print(pivot_table.to_string())
        done(10, t0)
    print_peak_memory(dev)


if __name__ == "__main__":
    main()
