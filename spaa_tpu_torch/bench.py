"""Headline benchmark of the port on one GPU (counterpart of the root
``bench.py``, which measures ``spaa_tpu`` on its accelerator).

    python -m spaa_tpu_torch.bench [--attack-dtype bfloat16]

Primary metric: SPAA attack wall-clock per (stealth loss, d_thr) config,
against the reference's 42.5 s per config across the three classifiers
on its own GPU (BASELINE.md, reference ``projector_based_attack.py:83``).
For each of ResNet-18, VGG-16 and Inception-v3, the whole 12-config sweep
runs as ONE 132-image batch of 50 SPAA iterations (per-sample stealth
weights, d_thr and target flags, the layout of ``bench.py:228-237``)
through the frozen PCNet, whose warp is the fixed-grid CUDA kernel
(``ops/warp.py``). The first sweep of each classifier runs untimed (the
kernel build, cuDNN's plans); the timed sweep over the three classifiers
is the best of ``--reps``. No PNG is written.

When a trained PCNet checkpoint is found (``<root>/checkpoint/
*_PCNet_l1+ssim_*.flax`` with ``<root>/sim_benchmark/setups/sim_setup``,
under ``$SPAA_BENCH_DATA_ROOT``, then ``<tmp>/simbench`` with ``<tmp>``
the system's temporary directory, then the repository), its weights and
the setup's scene and mask are used (``warp_source: "trained_ckpt"``);
else an emulated converged warp on ``spaa_tpu``'s initial draw. The
repository commits such a checkpoint, so a run from a checkout always
finds one and never takes the emulated branch. A fresh
start rebuilds the artifacts first, outside every timed window: the
committed checkpoint seeds the cache, ``SimProCams(seed=7)`` writes the
setup, then the SPAA sweep with ``load_pretrained`` and its replay.
``SPAA_BENCH_NO_REGEN=1`` skips that.

Secondary metrics: ``pcnet_infer_fps`` (the simplified PCNet forward on
11 images, 20 chained forwards, best of 3), ``pcnet_train_iters_per_s``
(50 iterations of ``train_model`` at batch 24, l1+ssim with the
curriculum, the three-group optimizer), ``pcnet_train_e2e_s`` (the
default 2000-iteration config with 10 validations on 200 pairs, after a
warm-up segment; the upload timed apart as ``train_data_upload_s``) and
``summarize_spaa_s_per_setup`` (the second of two SPAA summarize runs of
the setup, when its attack outputs exist).

Prints ONE JSON line on stdout, ``bench.py``'s keys plus the provenance
(``device``, ``power_limit_w``, ``attack_dtype``, the repetitions and
training iterations run, the warp's launches); diagnostics go to stderr.
Runs on ``cuda`` unless ``--device cpu``; float32 with TF32 off unless
``--attack-dtype bfloat16`` (the shading CNN and the classifiers; the
warp stays float32).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from os.path import abspath, basename, dirname, exists, isdir, join

import numpy as np
import torch

BASELINE_S = 42.5   # ref projector_based_attack.py:83, per (loss, d_thr)
N_CONFIGS = 12      # the SPAA sweep: 3 stealth losses x 4 d_thr
CLASSIFIERS = ("resnet18", "vgg16", "inception_v3")
CAM_HW = (240, 320)   # benchmark cam_im_sz [320, 240]
PRJ_HW = (256, 256)   # benchmark prj_im_sz [256, 256]
CP_SZ = (240, 240)    # classifier_crop_sz
BATCH = 11 * N_CONFIGS  # the whole sweep as ONE batch
ATTACK_ITERS = 50
REPS = 3              # timed sweeps over the three classifiers
INFER_BATCH, INFER_CHAIN, INFER_REPS = 11, 20, 3
STEP_PAIRS, STEP_BATCH, STEP_ITERS, STEP_REPS = 96, 24, 50, 2
E2E_PAIRS = (500, 200)  # training, validation pairs

REPO = dirname(dirname(abspath(__file__)))
CKPT_GLOB = "*_PCNet_l1+ssim_*.flax"
# the emulated converged WarpingNet (bench.py:183-191): affine scale ~0.85
# and a quiet grid refiner
EMULATED_AFFINE = [[[0.85, 0.02, 0.01], [-0.02, 0.85, -0.01]]]
EMULATED_REFINE_SCALE = 0.01


def default_root() -> str:
    """Where a fresh start rebuilds the artifacts: ``simbench`` in the
    system's temporary directory (``$TMPDIR``, else ``/tmp``)."""
    return join(tempfile.gettempdir(), "simbench")


def _find_sim_artifacts():
    """(PCNet checkpoint, setup dir or None), or (None, None): the first
    root holding a ``*_PCNet_l1+ssim_*.flax`` checkpoint."""
    roots = [os.environ.get("SPAA_BENCH_DATA_ROOT"), default_root(), REPO]
    for root in roots:
        if not root or not isdir(root):
            continue
        hits = sorted(glob.glob(join(root, "checkpoint", CKPT_GLOB)))
        if hits:
            setup = join(root, "sim_benchmark", "setups", "sim_setup")
            return hits[-1], (setup if isdir(setup) else None)
    return None, None


def _spaa_outputs(setup_path) -> bool:
    """Whether the setup holds SPAA's projections and their replay."""
    from spaa_tpu_torch.attack.orchestrate import to_attacker_cfg_str
    cfg_str = to_attacker_cfg_str("SPAA")[0]
    return (setup_path is not None
            and isdir(join(setup_path, "prj/adv", cfg_str))
            and isdir(join(setup_path, "cam/raw/adv", cfg_str)))


def _ensure_bench_artifacts(dev, log) -> None:
    """Rebuild the trained setup and its SPAA outputs when either is
    missing, under ``$SPAA_BENCH_DATA_ROOT`` or :func:`default_root`: the
    committed checkpoint seeds the cache, ``SimProCams(seed=7)`` writes
    the setup (500 + 200 pairs), then the SPAA sweep with
    ``load_pretrained`` and the simulated replay."""
    if os.environ.get("SPAA_BENCH_NO_REGEN"):
        return
    ckpt, setup = _find_sim_artifacts()
    if ckpt is not None and _spaa_outputs(setup):
        return
    from spaa_tpu_torch.attack.orchestrate import (
        get_attacker_cfg, project_capture_real_attack,
        run_projector_based_attack)
    from spaa_tpu_torch.utils.seed import reset_rng_seeds
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)

    root = os.environ.get("SPAA_BENCH_DATA_ROOT") or default_root()
    data_root = join(root, "sim_benchmark")
    t0 = time.perf_counter()
    os.makedirs(join(root, "checkpoint"), exist_ok=True)
    for f in glob.glob(join(REPO, "checkpoint", CKPT_GLOB)):
        dst = join(root, "checkpoint", basename(f))
        if not exists(dst):
            shutil.copy2(f, dst)
            log(f"[bench] seeded checkpoint cache from committed {f}")
    reset_rng_seeds(0)
    sim = SimProCams(dict(DEFAULT_SIM_SETUP_INFO), seed=7)
    if not isdir(join(data_root, "setups", "sim_setup")):
        log("[bench] fresh start: generating the synthetic setup "
            "(host-side, deterministic)")
        sim.make_setup(data_root, "sim_setup", num_train=500, num_test=200)
    cfg = get_attacker_cfg("SPAA", data_root, ["sim_setup"],
                           load_pretrained=True)
    run_projector_based_attack(cfg, device=dev)   # loads ckpt or trains
    project_capture_real_attack(cfg, sim)
    log(f"[bench] sim artifacts (re)built in "
        f"{time.perf_counter() - t0:.1f} s")


def _load_setup_scene_mask(setup_path, log):
    """The setup's scene [1, H, W, 3] and binary direct-light mask
    [H, W, 1], float32 numpy (the reference image and the checkerboard
    captures only)."""
    from spaa_tpu_torch.train.data import nayar_separation
    from spaa_tpu_torch.utils.imgproc_host import threshold_im
    from spaa_tpu_torch.utils.io import imread_dir
    cam_ref = imread_dir(join(setup_path, "cam/raw/ref"))
    im_direct, _ = nayar_separation(imread_dir(join(setup_path,
                                                     "cam/raw/cb")), b=0.9)
    im_mask, _, _ = threshold_im(im_direct)
    log(f"[bench] setup scene+mask loaded from {setup_path} "
        f"(mask fill {im_mask.mean():.2f})")
    return cam_ref[1:2], im_mask.astype(np.float32)[..., None]


def emulate_converged_warp(model):
    """``bench.py:183-191``'s edits, in place: the benchmark affine and
    the grid refiner's weights x 0.01 (a converged warp is smooth)."""
    wn = model.warping_net
    with torch.no_grad():
        wn.affine_mat.copy_(torch.tensor(EMULATED_AFFINE))
        for p in wn.grid_refine_net.parameters():
            p.mul_(EMULATED_REFINE_SCALE)
    return model


def emulated_pcnet():
    """PCNet at ``CAM_HW`` with ``spaa_tpu``'s initial draw for key 0 and
    :func:`emulate_converged_warp`'s edits."""
    from spaa_tpu_torch.models.pcnet import PCNet
    from spaa_tpu_torch.utils.threefry import prng_key
    return emulate_converged_warp(
        PCNet(out_size=CAM_HW).init_weights(prng_key(0)))


def sweep_layout():
    """The sweep's per-sample arrays (``bench.py:228-237``), as numpy,
    the first ``BATCH`` rows: per config 10 targeted + 1 untargeted
    samples, the caml2 / camdE / camdE_caml2 weights x 4 d_thr in 5, 7,
    9, 11, camdE-active configs last. Returns ``(target_idx, targeted,
    weights, d_thr, prj_init, camde_range)``."""
    target_idx = np.tile(np.arange(11, dtype=np.int64) * 37 % 1000,
                         N_CONFIGS)
    targeted = np.tile(np.asarray([True] * 10 + [False]), N_CONFIGS)
    wcfg = np.asarray([[0.0, 1.0, 0.0]] * 4 + [[0.0, 0.0, 1.0]] * 4
                      + [[0.0, 1.0, 1.0]] * 4, np.float32)
    weights = np.repeat(wcfg, 11, axis=0)
    d_thr = np.repeat(np.asarray([5.0, 7.0, 9.0, 11.0] * 3, np.float32), 11)
    prj_init = np.full((BATCH, *PRJ_HW, 3), 0.5, np.float32)
    b = BATCH
    return (target_idx[:b], targeted[:b], weights[:b], d_thr[:b], prj_init,
            (min(4 * 11, b), b))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build(dev, attack_dtype, log):
    """PCNet (trained checkpoint, else the emulated warp), its attack
    forward and one sweep per classifier, each run once untimed. Returns
    ``(sweeps, pcnet_apply, warp_source, clf_weights_source)``; each
    sweep runs the classifier's 132-image attack and checks that its
    outputs are finite."""
    from spaa_tpu_torch.attack.orchestrate import (make_attack_logits_fn,
                                                   make_pcnet_fn)
    from spaa_tpu_torch.attack.spaa import SpaaConfig, spaa_attack_batched
    from spaa_tpu_torch.models.classifiers import Classifier
    from spaa_tpu_torch.models.pcnet import PCNet
    from spaa_tpu_torch.train.pipeline import (TrainedModel, _frozen,
                                               _load_weights)

    rng = np.random.default_rng(0)
    cam_scene = rng.random((1, *CAM_HW, 3), np.float32)
    mask = np.ones((*CAM_HW, 1), np.float32)
    t0 = time.perf_counter()
    ckpt, setup_path = _find_sim_artifacts()
    if ckpt is not None:
        # a checkpoint that is found and does not load raises
        model = _load_weights(PCNet(out_size=CAM_HW), ckpt)
        warp_source = "trained_ckpt"
        log(f"[bench] trained PCNet checkpoint loaded: {ckpt}")
        if setup_path is not None:
            cam_scene, mask = _load_setup_scene_mask(setup_path, log)
    else:
        model = emulated_pcnet()
        warp_source = "emulated"
    log(f"[bench] pcnet params ready ({warp_source}) "
        f"{time.perf_counter() - t0:.1f} s")

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    setup_info = {"prj_im_sz": [PRJ_HW[1], PRJ_HW[0]],
                  "cam_im_sz": [CAM_HW[1], CAM_HW[0]],
                  "classifier_crop_sz": list(CP_SZ)}
    scene_t = t(cam_scene)
    trained = TrainedModel(_frozen(model, dev), t(mask), scene_t,
                           setup_info, None, "PCNet")
    t0 = time.perf_counter()
    pcnet_apply = make_pcnet_fn(trained, compute_dtype=attack_dtype)
    log(f"[bench] pcnet_fn (simplify + warp tables) "
        f"{time.perf_counter() - t0:.1f} s")

    tgt, targeted, w, dt, prj_init, camde_range = sweep_layout()
    args = (t(prj_init), t(tgt, torch.long), t(targeted, torch.bool), t(w),
            t(dt))
    cfg = SpaaConfig(iters=ATTACK_ITERS, camde_range=camde_range)
    sweeps, sources = [], []
    for name in CLASSIFIERS:
        t0 = time.perf_counter()
        clf = Classifier(name, device=dev)
        sources.append(clf.params_source)
        logits_fn = make_attack_logits_fn(clf, CP_SZ, attack_dtype)
        log(f"[bench] {name}: params ready ({clf.params_source}) "
            f"{time.perf_counter() - t0:.1f} s")

        def sweep(_f=logits_fn, _name=name):
            cam_best, prj_best = spaa_attack_batched(
                pcnet_apply, _f, scene_t, *args, cfg)
            if not (torch.isfinite(cam_best).all()
                    and torch.isfinite(prj_best).all()):
                raise FloatingPointError(f"non-finite {_name} sweep output")

        t0 = time.perf_counter()
        sweep()
        _sync(dev)
        log(f"[bench] {name}: first run {time.perf_counter() - t0:.1f} s")
        sweeps.append(sweep)
    srcs = set(sources)
    clf_weights_source = ("random" if srcs == {"random"} else
                          "converted" if "random" not in srcs else "mixed")
    return sweeps, pcnet_apply, warp_source, clf_weights_source


def chained_forwards(pcnet_apply, prj, n: int):
    """The sum over ``n`` forwards of ``prj + i * 1e-8`` of each output's
    mean (``bench.py:282-289``: perturbed so no forward repeats one
    before it), a tensor on ``prj``'s device."""
    acc = torch.zeros((), dtype=prj.dtype, device=prj.device)
    for i in range(n):
        acc = acc + torch.mean(pcnet_apply(prj + i * 1e-8))
    return acc


def _bench_infer_fps(pcnet_apply, dev, log) -> float:
    """PCNet inference FPS at the reference's attack batch (11 images):
    ``INFER_CHAIN`` chained forwards, one synchronisation at the end,
    best of ``INFER_REPS`` after a first run."""
    prj = torch.from_numpy(np.random.default_rng(2).random(
        (INFER_BATCH, *PRJ_HW, 3), np.float32)).to(dev)
    best = math.inf
    with torch.no_grad():
        for rep in range(INFER_REPS + 1):
            t0 = time.perf_counter()
            acc = float(chained_forwards(pcnet_apply, prj, INFER_CHAIN))
            if not math.isfinite(acc):
                raise FloatingPointError("non-finite PCNet inference")
            if rep:
                best = min(best, (time.perf_counter() - t0) / INFER_CHAIN)
    fps = INFER_BATCH / best
    log(f"[bench] pcnet inference: {best * 1e3:.3f} ms / {INFER_BATCH}-image "
        f"batch = {fps:.1f} FPS ({INFER_CHAIN} chained forwards)")
    return fps


def step_inputs():
    """The training step's seeded data (``bench.py:318-338``): the scene
    [1, H, W, 3], ``STEP_PAIRS`` float32 pairs and the minibatch plan
    [``STEP_ITERS``, ``STEP_BATCH``], from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    scene = rng.random((1, *CAM_HW, 3), np.float32)
    prj = rng.random((STEP_PAIRS, *PRJ_HW, 3), np.float32)
    cam = rng.random((STEP_PAIRS, *CAM_HW, 3), np.float32)
    idx = rng.integers(0, STEP_PAIRS, (STEP_ITERS, STEP_BATCH)).astype(
        np.int32)
    return scene, prj, cam, idx


def train_segment(model, scene, mask, arrays, idx, dev, step_losses=None):
    """``len(idx)`` iterations of ``train_model`` in one segment from
    ``model``'s weights: l1+ssim with the curriculum weight (``itr >
    400``), the three-group optimizer of the default config, no
    validation and no resume snapshot."""
    from spaa_tpu_torch.train.pipeline import make_pcnet_loss
    from spaa_tpu_torch.train.train import (get_model_train_cfg,
                                            make_pcnet_optimizer,
                                            train_model)
    cfg = get_model_train_cfg(["PCNet"], single=True)
    cfg.max_iters = cfg.valid_rate = len(idx)
    opt, sched = make_pcnet_optimizer(model, cfg)
    train_model(make_pcnet_loss(model, scene, mask), model, opt, sched,
                arrays, idx, cfg, dev, step_losses=step_losses)


def _fresh_pcnet(dev):
    """PCNet at ``CAM_HW`` with ``spaa_tpu``'s initial draw for key 0,
    and a copy of its weights to restart from."""
    from spaa_tpu_torch.models.pcnet import PCNet
    from spaa_tpu_torch.utils.threefry import prng_key
    model = PCNet(out_size=CAM_HW).init_weights(prng_key(0)).to(dev)
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def _bench_train_step(dev, log) -> float:
    """Training throughput: ``STEP_ITERS`` iterations of
    :func:`train_segment` at batch ``STEP_BATCH`` on ``STEP_PAIRS`` pairs
    already on the device, best of ``STEP_REPS`` after a first run, each
    from the same initial weights."""
    scene, prj, cam, idx = step_inputs()
    model, init = _fresh_pcnet(dev)
    scene_t = torch.from_numpy(scene).to(dev)
    mask = torch.ones((*CAM_HW, 1), device=dev)
    arrays = dict(inputs=torch.from_numpy(prj).to(dev),
                  targets=torch.from_numpy(cam).to(dev))
    best = math.inf
    for rep in range(STEP_REPS + 1):
        model.load_state_dict(init)
        _sync(dev)
        t0 = time.perf_counter()
        train_segment(model, scene_t, mask, arrays, idx, dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        if rep == 0:
            log(f"[bench] train segment first run {dt:.1f} s")
        else:
            best = min(best, dt)
    ips = STEP_ITERS / best
    log(f"[bench] train: {best / STEP_ITERS * 1e3:.2f} ms/iter = "
        f"{ips:.2f} it/s (2000-iter budget ~ {2000 / ips:.0f} s)")
    return ips


def _bench_train_e2e(dev, log, max_iters=None):
    """End-to-end training wall-clock through ``train_model``: the
    default config (2000 iterations unless ``max_iters``, batch 24,
    validation every 200 iterations on the validation pairs) on seeded
    uint8 data from ``default_rng(4)``, no resume snapshot. The upload is
    timed apart; one validation segment runs first as a warm-up. Returns
    ``(e2e_s, upload_s, iterations)``."""
    from spaa_tpu_torch.train.pipeline import make_pcnet_loss
    from spaa_tpu_torch.train.train import (get_model_train_cfg,
                                            make_evaluator,
                                            make_pcnet_optimizer,
                                            sample_batch_indices,
                                            train_model)
    rng = np.random.default_rng(4)
    scene = torch.from_numpy(rng.random((1, *CAM_HW, 3), np.float32)).to(dev)
    n_train, n_valid = E2E_PAIRS
    prj_train = rng.integers(0, 256, (n_train, *PRJ_HW, 3), np.uint8)
    cam_train = rng.integers(0, 256, (n_train, *CAM_HW, 3), np.uint8)
    prj_valid = rng.integers(0, 256, (n_valid, *PRJ_HW, 3), np.uint8)
    cam_valid = rng.integers(0, 256, (n_valid, *CAM_HW, 3), np.uint8)
    model, init = _fresh_pcnet(dev)
    mask = torch.ones((*CAM_HW, 1), device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    arrays = dict(inputs=torch.from_numpy(prj_train).to(dev),
                  targets=torch.from_numpy(cam_train).to(dev))
    _sync(dev)
    upload_s = time.perf_counter() - t0
    log(f"[bench] train data upload (untimed window) {upload_s:.2f} s")

    cfg = get_model_train_cfg(["PCNet"], single=True)
    if max_iters is not None:
        cfg.max_iters = int(max_iters)
    cfg.batch_size = min(int(cfg.batch_size), n_train)
    idx = sample_batch_indices(n_train, cfg.batch_size, cfg.max_iters)
    evaluator = make_evaluator(lambda x: model(x, scene, mask), prj_valid,
                               cam_valid, dev)
    loss_fn = make_pcnet_loss(model, scene, mask)

    def run(run_cfg):
        model.load_state_dict(init)
        opt, sched = make_pcnet_optimizer(model, run_cfg)
        _sync(dev)
        t0 = time.perf_counter()
        train_model(loss_fn, model, opt, sched, arrays,
                    idx[:run_cfg.max_iters], run_cfg, dev,
                    valid_fn=evaluator)
        _sync(dev)
        return time.perf_counter() - t0

    warm = cfg.copy()
    warm.max_iters = min(int(cfg.valid_rate), int(cfg.max_iters))
    log(f"[bench] train e2e warm-up ({warm.max_iters} iterations) "
        f"{run(warm):.1f} s")
    e2e = run(cfg)
    log(f"[bench] train e2e: {e2e:.1f} s for {cfg.max_iters} iterations "
        f"incl. {math.ceil(cfg.max_iters / cfg.valid_rate)} validations + "
        f"host loop (data upload {upload_s:.2f} s reported separately)")
    return e2e, upload_s, int(cfg.max_iters)


def _bench_summarize(dev, log):
    """SPAA summarize of the setup (full recreate), run twice; the second
    run's seconds, or None when the setup or its attack outputs are
    absent."""
    from spaa_tpu_torch.attack.summarize import summarize_single_attacker
    _, setup_path = _find_sim_artifacts()
    if not _spaa_outputs(setup_path):
        return None
    data_root = dirname(dirname(setup_path))
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        table = summarize_single_attacker("SPAA", data_root,
                                          [basename(setup_path)], device=dev)
        times.append(time.perf_counter() - t0)
    log(f"[bench] SPAA summarize ({len(table)} cells, full recreate): first "
        f"{times[0]:.1f} s, second {times[1]:.1f} s")
    return times[1]


def _power_limit_w(dev):
    """The card's power limit in W from ``nvidia-smi``; None off the card."""
    if dev.type != "cuda":
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={idx}",
                          "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.strip().splitlines()[0])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--attack-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="compute type of the shading CNN and classifiers")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed sweeps over the classifiers (best kept)")
    ap.add_argument("--train-iters", type=int, default=None,
                    help="cut the end-to-end training run (default: the "
                         "config's 2000 iterations)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from spaa_tpu_torch.ops import warp as W
    from spaa_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"[bench] device={dev} ({name}) torch {torch.__version__} "
        f"attack_dtype={args.attack_dtype} reps={args.reps}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _ensure_bench_artifacts(dev, log)
        W.reset_launch_counts()
        sweeps, pcnet_apply, warp_source, clf_weights_source = _build(
            dev, args.attack_dtype, log)

    # timed: the 12-config sweep of every classifier, per config to match
    # the reference's 42.5 s anchor; best of the repetitions
    best = math.inf
    for rep in range(args.reps):
        _sync(dev)
        t0 = time.perf_counter()
        for sweep in sweeps:
            sweep()
        _sync(dev)
        dt = time.perf_counter() - t0
        log(f"[bench] rep {rep}: {dt:.3f} s sweep "
            f"({dt / N_CONFIGS:.3f} s/config)")
        best = min(best, dt)
    del sweeps

    infer_fps = _bench_infer_fps(pcnet_apply, dev, log)
    launches = dict(W.LAUNCHES)
    if dev.type == "cuda":
        n_sweeps = (1 + args.reps) * len(CLASSIFIERS)
        want = {"fixed_warp_fwd": n_sweeps * ATTACK_ITERS
                + (1 + INFER_REPS) * INFER_CHAIN,
                "fixed_warp_bwd": n_sweeps * ATTACK_ITERS}
        if launches != want:
            raise RuntimeError(f"warp launches {launches}, expected {want}")
    log(f"[bench] warp launches (sweeps and inference): {launches}")
    with contextlib.redirect_stdout(buf):
        train_ips = _bench_train_step(dev, log)
        train_e2e, upload_s, e2e_iters = _bench_train_e2e(dev, log,
                                                          args.train_iters)
        summarize_s = _bench_summarize(dev, log)

    per_config = best / N_CONFIGS
    print(json.dumps({
        "metric": "spaa_attack_config_wallclock",
        "value": per_config,
        "unit": "s",
        "vs_baseline": BASELINE_S / per_config,
        "extra": {
            "pcnet_infer_fps": infer_fps,
            "pcnet_train_iters_per_s": train_ips,
            "pcnet_train_2000it_s": 2000 / train_ips,
            "pcnet_train_e2e_s": train_e2e,
            "train_data_upload_s": upload_s,
            **({"summarize_spaa_s_per_setup": summarize_s}
               if summarize_s is not None else {}),
            "warp_source": warp_source,
            "clf_weights_source": clf_weights_source,
            "sweep_wallclock_s": best,
            "device": name,
            "power_limit_w": _power_limit_w(dev),
            "attack_dtype": args.attack_dtype,
            "reps": args.reps,
            "train_e2e_iters": e2e_iters,
            "warp_launches": launches,
        },
    }), flush=True)


if __name__ == "__main__":
    main()
