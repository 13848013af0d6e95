#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spaa_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without printing a result when either is missing or any phase fails.
Phases, each printed on its own lines:

1. device: name, ``nvidia-smi`` name and power limit, TF32 flags (off);
2. build: every CUDA source of the port, one ``nvcc`` each, in parallel;
3. kernels: each kernel's bands, registers and shared memory; each kernel
   against its plain PyTorch version on the card at the main path's shapes
   (the committed checkpoint's baked grid with the fixture's mask folded
   in, B = 132) and on a 90-degree-rotated and a zoom-in grid (B = 5):
   max-abs difference, bitwise run-to-run check; then times (CUDA events
   around 50 back-to-back launches, median of 7 such runs, with their
   spread) of the kernel, the plain version and the one PyTorch library
   call computing the same function (``F.grid_sample(align_corners=True)
   * mask`` and its input gradient), and the least time the card could
   take (bytes over 3.35 TB/s or flops over 67 TFLOP/s float32, the H100
   SXM data-sheet rates);
4. main path: the SPAA sweep of one setup at full width (projector
   256x256, camera 240x320, crop 240x240, ResNet-18 at 224x224): the
   committed sim-setup fixture and PCNet checkpoint, 12 configs x 11
   samples = 132 images, 50 iterations, float32, 264 PNGs written; launch
   counts of every kernel in that run, wall-clock, peak memory, output
   checks, and the card's PCNet forward against the CPU's on 2 images.

Before the last line it prints the kernels as one JSON object and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from os.path import abspath, dirname, join

REPO = dirname(abspath(__file__))
CKPT_NAME = "sim_setup_PCNet_l1+ssim_500_24_2000_0.001_0.2_800_0.0001.flax"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak memory rate
FP32_FLOPS_PER_S = 67e12      # float32 outside the tensor cores
ITERS = 50
NUM_TRAIN = 500               # training pairs of the sim benchmark setup


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, launches=50, runs=7, warmup=3):
    """Time of one call of ``fn()`` in ms: CUDA events around ``launches``
    back-to-back calls, divided by the count; the median of ``runs`` such
    runs, with their (min, max) spread."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times), min(times), max(times)


def wavy_grid(ho, wo, scale=0.9, rot_deg=2.0, wiggle=0.03,
              shift=(0.02, -0.01)):
    """[1, Ho, Wo, 2] smooth test grid (the parity tests' ``_wavy_grid``)."""
    import numpy as np
    yy, xx = np.meshgrid(np.linspace(-1, 1, ho), np.linspace(-1, 1, wo),
                         indexing="ij")
    th = np.deg2rad(rot_deg)
    gx = scale * (np.cos(th) * xx - np.sin(th) * yy) \
        + wiggle * np.sin(3 * yy) + shift[0]
    gy = scale * (np.sin(th) * xx + np.cos(th) * yy) \
        + wiggle * np.cos(2 * xx) + shift[1]
    return np.stack([gx, gy], -1)[None].astype(np.float32)


def make_data_root(tmp):
    """The fixture setup under <tmp>/data, the committed checkpoint under
    <tmp>/checkpoint, and NUM_TRAIN empty placeholders in
    prj_share/train: the attack loads no training image, but the
    checkpoint key holds the setup's training-pair count."""
    data = join(tmp, "data")
    shutil.copytree(join(REPO, "spaa_tpu_torch", "assets", "sim_setup"),
                    join(data, "setups", "sim_setup"))
    os.makedirs(join(tmp, "checkpoint"))
    shutil.copy(join(REPO, "checkpoint", CKPT_NAME),
                join(tmp, "checkpoint", CKPT_NAME))
    train = join(data, "prj_share", "train")
    os.makedirs(train)
    for i in range(NUM_TRAIN):
        open(join(train, f"img_{i + 1:04d}.png"), "wb").close()
    return data


def phase_device():
    import torch
    from spaa_tpu_torch.utils.device import resolve_device
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return dev, smi.splitlines()[0]


def phase_build():
    from spaa_tpu_torch.ops import _build
    t0 = time.time()
    _build.build_all()
    log(f"[build] {', '.join(_build.SOURCES)} built in "
        f"{time.time() - t0:.2f} s (nvcc, sm_90a)")
    for name, out in _build.BUILD_LOGS.items():
        for line in out.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            if spills and spills.groups() != ("0", "0"):
                raise AssertionError(f"{name}.cu spills registers: {line}")


def warp_bounds(warp, n, c):
    """Least time of each pass: bytes that must move (the source pixels
    the tables read, every output written, the tables) over HBM rate vs
    2 flops per tap and channel over the float32 rate."""
    import torch
    out = {}
    for name, table, src_px, dst_px in (
            ("fwd", warp.fwd, warp.src_hw, warp.out_hw),
            ("bwd", warp.bwd, warp.out_hw, warp.src_hw)):
        read_px = int(torch.unique(table.col).numel())
        byts = 4 * n * c * (read_px + dst_px[0] * dst_px[1]) + table.nbytes()
        flops = 2 * int(table.col.numel()) * n * c
        t_b, t_f = byts / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        out[name] = dict(bound_ms=1e3 * max(t_b, t_f),
                         bound_by="bytes" if t_b >= t_f else "operations",
                         bytes=byts, flops=flops, read_px=read_px,
                         nnz=int(table.col.numel()))
    return out


def check_kernel(warp, x, dout, what):
    """The kernel against its plain version, forward and backward, two runs
    each: max-abs errors; raises past 1e-5 or if the runs differ."""
    import torch
    from spaa_tpu_torch.ops import warp as W
    fwd = [W.warp_forward(warp, x) for _ in range(2)]
    bwd = [W.warp_backward(warp, dout) for _ in range(2)]
    torch.cuda.synchronize()
    err_f = float((fwd[0] - W.warp_forward_plain(warp, x)).abs().max())
    err_b = float((bwd[0] - W.warp_backward_plain(warp, dout)).abs().max())
    bit_f, bit_b = torch.equal(fwd[0], fwd[1]), torch.equal(bwd[0], bwd[1])
    log(f"[kernels] {what} B={x.shape[0]}: max|kernel-plain| fwd "
        f"{err_f:.3e} bwd {err_b:.3e}; bitwise run to run fwd {bit_f} bwd "
        f"{bit_b}")
    if not (err_f <= 1e-5 and err_b <= 1e-5):
        raise AssertionError(f"fixed warp kernel disagrees with its plain "
                             f"version on {what}: fwd {err_f}, bwd {err_b} "
                             f"(tol 1e-5)")
    if not (bit_f and bit_b):
        raise AssertionError(f"fixed warp kernel is not bitwise "
                             f"deterministic run to run on {what}")
    return err_f, err_b


def band_summary(warp, what, c=3):
    """Log each pass's bands: count, busy, over budget (gathered from device
    memory), with a remainder, staged window and shared memory a block."""
    from spaa_tpu_torch.ops import warp as W
    out = {}
    for k, table, backward in (("fwd", warp.fwd, False),
                               ("bwd", warp.bwd, True)):
        b = table.bands
        modes = b.band[:, 0].cpu()
        out[k] = dict(
            bands=b.n_bands, busy=b.n_busy,
            over_budget=int(((modes & 3) == W.BAND_GLOBAL).sum()),
            remainder=int(((modes & W.BAND_HAS_REMAINDER) != 0).sum()))
        log(f"[kernels] {what} {k}: {b.n_bands} bands of {b.band_px} px, "
            f"{b.n_busy} busy, {out[k]['over_budget']} over budget, "
            f"{out[k]['remainder']} with remainder taps, {b.seg.shape[0]} "
            f"segments, widest window {b.stage_px} px, "
            f"{W.smem_bytes(table, c, backward)} B dynamic shared memory a "
            f"block")
    return out


def phase_kernels(trained, dev, batch):
    """Each kernel vs its plain version at the main path's shapes, and on
    two grids that leave its common path (B = 5): a 90-degree rotation
    (bands over the staging budget) and a zoom-in (remainder taps)."""
    import torch
    import torch.nn.functional as F
    from spaa_tpu_torch.attack.orchestrate import pcnet_warp
    from spaa_tpu_torch.ops import warp as W

    cache = trained.simplify()
    warp = pcnet_warp(trained, cache)
    hp, wp = warp.src_hw
    ho, wo = warp.out_hw
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((batch, hp, wp, 3), generator=gen, device=dev)
    dout = torch.randn((batch, 3, ho, wo), generator=gen, device=dev)
    log(f"[kernels] fixed warp tables: fwd {warp.fwd.rows} rows, "
        f"{warp.fwd.col.numel()} taps (max {warp.fwd.ell_col.shape[1]}/row); "
        f"bwd {warp.bwd.rows} rows, max fan-in {warp.bwd.ell_col.shape[1]}")
    band_summary(warp, "main grid")
    for k, backward in (("fwd", False), ("bwd", True)):
        attrs = W.kernel_attrs(backward)
        log(f"[kernels] fixed_warp_{k}_kernel: {attrs}")
        if attrs["local_bytes"]:
            raise AssertionError(f"fixed_warp_{k}_kernel uses local memory "
                                 f"(register spills): {attrs}")
    err_f, err_b = check_kernel(warp, x, dout, "main grid")

    mask = trained.mask[..., 0]
    for what, kw, key, flag in (
            ("rotated_90 grid", dict(rot_deg=90.0), "over_budget", "fwd"),
            ("zoom_in grid", dict(scale=0.5), "remainder", "bwd")):
        other = W.build_fixed_warp(wavy_grid(ho, wo, **kw), (hp, wp),
                                   dst_weight=mask, device=dev)
        if band_summary(other, what)[flag][key] == 0:
            raise AssertionError(f"{what} has no {flag} band {key}")
        check_kernel(other, x[:5], dout[:5], what)

    # the library yardstick (never called by the port): grid_sample * mask
    x_nchw = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    grid = cache.fine_grid.expand(batch, -1, -1, -1)

    def lib_fwd():
        return F.grid_sample(x_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True) * mask

    lib_out = lib_fwd()
    lib_grad, = torch.autograd.grad(lib_out, x_nchw, dout, retain_graph=True)
    with torch.no_grad():
        err_lib_f = float((lib_out - W.warp_forward_plain(warp, x))
                          .abs().max())
        err_lib_b = float((lib_grad.permute(0, 2, 3, 1)
                           - W.warp_backward_plain(warp, dout)).abs().max())
        t = dict(
            fwd=cuda_ms(lambda: W.warp_forward(warp, x)),
            fwd_plain=cuda_ms(lambda: W.warp_forward_plain(warp, x),
                              launches=3, runs=3),
            fwd_lib=cuda_ms(lib_fwd),
            bwd=cuda_ms(lambda: W.warp_backward(warp, dout)),
            bwd_plain=cuda_ms(lambda: W.warp_backward_plain(warp, dout),
                              launches=3, runs=3))
    t["bwd_lib"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, x_nchw, dout, retain_graph=True), launches=10, runs=5)
    bounds = warp_bounds(warp, batch, 3)
    for k in ("fwd", "bwd"):
        b = bounds[k]
        med, lo, hi = t[k]
        log(f"[kernels] fixed_warp_{k}: kernel={med:.4f} ms (min {lo:.4f}, "
            f"max {hi:.4f} over 7 runs of 50 launches) "
            f"plain={t[k + '_plain'][0]:.4f} ms "
            f"library={t[k + '_lib'][0]:.4f} ms "
            f"bound={b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
            f"{b['flops']} flop) -> {100 * b['bound_ms'] / med:.1f}% of "
            f"bound")
    log(f"[kernels] library grid_sample*mask vs plain: fwd "
        f"{err_lib_f:.3e}, input grad {err_lib_b:.3e}")
    del lib_out
    rows = []
    for k, err in (("fwd", err_f), ("bwd", err_b)):
        rows.append(dict(
            name=f"fixed_warp_{k}", route="cuda",
            source="spaa_tpu_torch/csrc/fixed_warp.cu",
            replaces="spaa_tpu/ops/pallas/warp.py:234", launches=None,
            max_abs_err=err, ms=t[k][0], plain_ms=t[k + "_plain"][0],
            bound_ms=bounds[k]["bound_ms"], bound_by=bounds[k]["bound_by"],
            library_ms=t[k + "_lib"][0]))
    return rows


def phase_main_path(cfg, trained, dev):
    """The SPAA sweep of one setup: every (stealth loss x d_thr) config of
    ``cfg`` x 11 samples as one batch, ``cfg.attack_iters`` iterations."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.attack.spaa import spaa_attack_batched
    from spaa_tpu_torch.models.classifiers import (Classifier,
                                                   load_imagenet_labels)
    from spaa_tpu_torch.ops import warp as W
    from spaa_tpu_torch.ops.image import center_crop
    from spaa_tpu_torch.utils.io import imread

    data_root = cfg.data_root
    iters = int(cfg.attack_iters)
    n_cfg = len(cfg.stealth_losses) * len(cfg.d_threshes)
    setup_path = join(data_root, "setups", "sim_setup")
    info = trained.setup_info
    cp_sz = tuple(int(v) for v in info["classifier_crop_sz"])
    w_cam, h_cam = info["cam_im_sz"]
    cam_scene = center_crop(torch.from_numpy(imread(
        join(setup_path, "cam/raw/ref/img_0002.png")))[None],
        (h_cam, w_cam)).to(dev)
    target_idx = list(load_imagenet_labels(
        join(data_root, "imagenet10_clsidx_to_labels.txt")))[:10]
    clf = Classifier("resnet18", join(REPO, "checkpoint"), device=dev)
    _, p, pred = clf(cam_scene, cp_sz)
    true_idx = int(pred[0, 0])
    source = ("torchvision .pth" if clf.loaded_pretrained
              else "deterministic init, seed 0")
    log(f"[main] ResNet-18 weights: {clf.params_source} ({source}); "
        f"scene class {true_idx} p={p.max():.3f}")
    cfg_str = O.to_attacker_cfg_str("SPAA")[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.reset_launch_counts()
    t0 = time.time()
    cam_best, prj_best = O._run_spaa_sweep(
        cfg, trained, clf, cam_scene, target_idx, true_idx, info, setup_path,
        cfg_str, "resnet18")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(W.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    n_png = sum(len(f) for _, _, f in os.walk(join(setup_path, "prj/adv"))) \
        + sum(len(f) for _, _, f in os.walk(join(setup_path, "cam/infer/adv")))
    ok_out = all(bool(torch.isfinite(t).all()) and float(t.min()) >= 0.0
                 and float(t.max()) <= 1.0 for t in (cam_best, prj_best))
    log(f"[main] sweep: {wall:.3f} s wall ({wall / n_cfg:.3f} s/config) "
        f"for {cam_best.shape[0]} images x {iters} iterations; peak memory "
        f"{peak / 2**30:.3f} GiB; {n_png} PNGs; outputs finite and in "
        f"[0,1]: {ok_out}; launches {launches}")
    b = 11 * n_cfg
    if cam_best.shape != (b, h_cam, w_cam, 3) or prj_best.shape != \
            (b, *trained.setup_info["prj_im_sz"][::-1], 3):
        raise AssertionError(f"unexpected output shapes {cam_best.shape}, "
                             f"{prj_best.shape}")
    if not ok_out:
        raise AssertionError("sweep outputs are not finite in [0, 1]")
    if n_png != 2 * b:
        raise AssertionError(f"expected {2 * b} PNGs, found {n_png}")
    for k in ("fixed_warp_fwd", "fixed_warp_bwd"):
        if launches[k] != iters:
            raise AssertionError(f"{k} launched {launches[k]} times in the "
                                 f"sweep, expected {iters}")

    # steady-state iteration time, re-timed on the warm path (5 iterations)
    pcnet_apply = O.make_pcnet_fn(trained)
    logits_fn = O.make_attack_logits_fn(clf, cp_sz)
    (_, _, prj_init, tgt, targeted, w, dt,
     scfg) = O.build_spaa_sweep_arrays(cfg, info, target_idx, true_idx)

    def tt(a, dtype=torch.float32):
        return torch.from_numpy(a).to(dev, dtype)

    args = (pcnet_apply, logits_fn, cam_scene, tt(prj_init),
            tt(tgt, torch.long), tt(targeted, torch.bool), tt(w), tt(dt),
            scfg._replace(iters=5))
    torch.cuda.synchronize()
    t1 = time.time()
    spaa_attack_batched(*args)
    torch.cuda.synchronize()
    ms_iter = 1e3 * (time.time() - t1) / 5
    log(f"[main] steady state: {ms_iter:.2f} ms/iteration at B={b}")

    # the card's forward against the CPU's plain path on 2 images
    x = prj_best[:2].contiguous()
    with torch.no_grad():
        on_card = pcnet_apply(x).cpu()
    return dict(wall_s=wall, s_per_config=wall / n_cfg, ms_per_iter=ms_iter,
                peak_bytes=peak, launches=launches, on_card=on_card,
                prj_small=x.cpu())


def check_against_cpu(data_root, small, on_card):
    """PCNet forward of 2 sweep outputs on the CPU (plain warp, CPU convs)
    vs the card (kernel, cuDNN): float32, tolerance 1e-4."""
    import torch
    from spaa_tpu_torch.attack.orchestrate import make_pcnet_fn
    from spaa_tpu_torch.train.pipeline import load_pretrained_pcnet
    from spaa_tpu_torch.train.train import get_model_train_cfg
    mc = get_model_train_cfg(["PCNet"], data_root, ["sim_setup"])
    trained, _ = load_pretrained_pcnet(mc, "sim_setup", device="cpu")
    with torch.no_grad():
        on_cpu = make_pcnet_fn(trained)(small)
    err = float((on_cpu - on_card).abs().max())
    log(f"[main] PCNet forward card vs CPU on 2 images: max|diff|={err:.3e}")
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU PCNet forwards disagree: {err}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.time()
    dev, smi = phase_device()
    phase_build()

    from spaa_tpu_torch.attack.orchestrate import get_attacker_cfg
    from spaa_tpu_torch.train.pipeline import load_pretrained_pcnet
    from spaa_tpu_torch.train.train import get_model_train_cfg
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_root = make_data_root(tmp)
        mc = get_model_train_cfg(["PCNet"], data_root, ["sim_setup"])
        trained, _ = load_pretrained_pcnet(mc, "sim_setup", device=dev)
        rows = phase_kernels(trained, dev, batch=132)
        cfg = get_attacker_cfg("SPAA", data_root, ["sim_setup"])
        cfg.classifier_names = ["resnet18"]
        cfg.attack_iters = ITERS
        res = phase_main_path(cfg, trained, dev)
        check_against_cpu(data_root, res["prj_small"], res["on_card"])
    for r in rows:
        r["launches"] = res["launches"][r["name"]]
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
