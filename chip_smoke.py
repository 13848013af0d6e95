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
   SXM data-sheet rates); the forward's time and bound also at B = 11,
   the bench's inference batch;
4. conv_route: the routes of ShadingNetSPAA's stride-1 3x3 convolutions
   (``ops/conv.py``), timed at first use of each key: one forward of the
   attack's PCNet at B = 132 and one of the model at training's B = 24 fill
   the table; per key both routes' median times and rates, the routes
   against each other (within 1e-5), the routed backward against
   ``F.conv2d``'s, and the kernels of each route and of the input-gradient
   problem the transposed route poses; the main path's sweep then prints
   its calls on each route;
5. main path: the SPAA sweep of one setup at full width (projector
   256x256, camera 240x320, crop 240x240, ResNet-18 at 224x224): the
   committed sim-setup fixture and PCNet checkpoint, 12 configs x 11
   samples = 132 images, 50 iterations, float32, 264 PNGs written; launch
   counts of every kernel in that run, wall-clock, peak memory, output
   checks, and the card's PCNet forward against the CPU's on 2 images;
6. sim: the port's own ``SimProCams`` (seed 7) writes the benchmark-size
   setup (500 training and 200 validation pairs) in a second data root:
   host time; mask and corners equal the committed fixture's;
7. train: ``train_eval_pcnet`` on that setup at full width (batch 24),
   the default config but ``max_iters`` 200 and ``valid_rate`` 100:
   ms per training iteration (steady state, re-timed), the loss at the
   first and last segment, the final validation PSNR/RMSE/SSIM against
   the untrained model's and a floor of 30 dB, peak memory; the port's
   loader reads the checkpoint back. The training run uses PyTorch's
   deterministic kernels: with the default ones, rounding that differs
   from run to run sends some runs into a mode that stays near 22 dB, so
   only a run that repeats bit for bit can be held to the floor;
8. compennet: ``train_eval_compennet_pp`` on that setup at full width,
   on deterministic kernels like ``[train]``: CompenNet's one-time
   pre-training at its default 500 iterations (batch 48), then CompenNet++
   at ``max_iters`` 200 (batch 24, ``valid_rate`` 100): the pre-training's
   seconds, the final validation PSNR/RMSE/SSIM against the untrained
   CompenNet++'s and a floor, peak memory; the port's loader reads the
   checkpoint back; then each model's iteration re-timed on the default
   kernels (ms, steady state);
9. multisetup: a data root of two setups (a copy of ``sim_setup`` and
   ``sim_setup_2`` from ``SimProCams(seed=20)``, 500 + 200 pairs, written
   by a child process that starts after ``[sim]``, host seconds;
   CompenNet's pre-training checkpoint copied, and never re-trained): 6
   iterations of ``train_pcnet_multi_setup`` and of
   ``train_compennet_pp_multi_setup`` with the two setups in one call
   against two sequential ``train_model`` runs each from the same draws,
   float32 on deterministic kernels (losses within rtol 1e-3), then ms per
   iteration of the two-setup call on the default kernels beside twice
   ``[train]``'s; ``pretrain_pcnets_multi_setup`` and
   ``pretrain_compennets_pp_multi_setup`` at chunk 2 (200 iterations, both
   setups trained, each PSNR above its untrained model's, then both
   cached); ``run_spaa_attack_multi_setup`` (ResNet-18, 132 images x 50
   iterations a setup: s/config, peak memory, 264 PNGs, 50 + 50 warp
   launches a setup, counted into the kernels line) and
   ``run_percal_attack_multi_setup`` (22 PNGs a setup, no launch) with
   ``load_pretrained`` and no mesh (waves of one); the multi-device path
   only with more than one card;
10. percal: ``run_projector_based_attack`` for PerC-AL+CompenNet++ with
   ``load_pretrained`` on that CompenNet++, ResNet-18, VGG-16 and
   Inception-v3, the fused 10 targeted + 1 untargeted batch x 50
   iterations each: seconds, ms/iteration (5 iterations re-timed), peak
   memory, 22 PNGs, finite outputs in [0, 1], no warp launch;
11. onepixel: ``run_projector_based_attack`` for One-pixel DE through the
   port's ``SimProCams`` at the default budget (block 41, 4 generations,
   population 50 untargeted and 10 targeted) on the three classifiers:
   per classifier the captures, classifier batches, cache misses (0),
   seconds split into captures and classification, success flags, 22
   PNGs, no warp launch; ResNet-18's untargeted initial population and
   first generation, captured once, classified on the card and on the CPU
   (probabilities within 1e-4, trial-versus-parent decisions that differ,
   bitwise equality of one image across batch sizes and positions); then
   ``python -m spaa_tpu_torch.digital_one_pixel_attack`` as a child;
12. main path on the trained setup, ResNet-18 (224x224), VGG-16 (224x224)
   and Inception-v3 (299x299): ``run_projector_based_attack`` with
   ``load_pretrained`` on the trained checkpoint, the full 132-image x
   50-iteration sweep per classifier: s/config, ms/iteration, peak memory,
   264 PNGs, finite outputs in [0, 1], 50 + 50 warp launches each;
13. pipeline: as subprocesses, ``python -m spaa_tpu_torch.main --steps
   6,7,8,9 --load-pretrained --train-iters 200`` (the replay of the 396
   SPAA projections through the port's ``SimProCams``, the SPAA
   summarize: 36 rows of 71 columns, 396 montages; then step 8: the
   CompenNet++ checkpoint loaded, the PerC-AL attack, the replay of its 33
   projections and its summarize, 3 rows; then step 9: One-pixel DE on
   the three classifiers and its summarize, 3 rows) and ``python -m
   spaa_tpu_torch.reproduce_paper_results --sim --summarize-only
   --keep-existing-imgs`` with the default attacker list (``stats_all``
   and the pivot table, 42 rows, 462 montages); their replay and
   summarize seconds, summarize phases and peak device memory; checks of
   row, column and montage counts, finite metrics and success rates in
   [0, 1]; then the SPAA ResNet-18 rows summarized again in this process on
   the card and on the CPU from the same PNGs: validation and stealth
   metrics within 1e-4 (the validation images of the 200-iteration PCNet
   and CompenNet++ are linked under the 2000-iteration keys summarize
   reads), success rates printed side by side (near-ties may flip a top-k
   between cuDNN and the CPU);
14. bench: ``python -m spaa_tpu_torch.bench`` as a child on that data
   root (``SPAA_BENCH_DATA_ROOT``: nothing is regenerated) at a cut depth,
   ``--reps 1`` and ``--train-iters 400`` (and its 200-iteration warm-up):
   its JSON line must hold every key of the root ``bench.py``'s line and
   the provenance, finite, ``warp_source`` the trained checkpoint, and
   the warp's launches of its sweeps (50 + 50 each: one untimed and one
   timed per classifier) and inference chain (20 forwards, 4 times),
   counted into the kernels line;
15. bf16: the ResNet-18 sweep of step 12 again with ``attack_dtype``
   bfloat16 (the shading CNN and the classifier; the warp stays float32):
   s/config, ms/iteration, 264 PNGs, finite outputs in [0, 1], 50 + 50
   launches, and the top-1 agreement of its camera images with the
   float32 sweep's under the float32 ResNet-18 (printed, not gated:
   bfloat16 is opt-in).

Before the last line it prints the kernels as one JSON object and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from os.path import abspath, dirname, join

# [train] runs on deterministic kernels; cuBLAS needs its workspace fixed
# before it starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
REPO = dirname(abspath(__file__))
CKPT_NAME = "sim_setup_PCNet_l1+ssim_500_24_2000_0.001_0.2_800_0.0001.flax"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak memory rate
FP32_FLOPS_PER_S = 67e12      # float32 outside the tensor cores
ITERS = 50
NUM_TRAIN = 500               # training pairs of the sim benchmark setup
NUM_VALID = 200               # validation pairs (bench.py:122)
TRAIN_ITERS = 200             # PCNet training budget of the smoke
VALID_RATE = 100
# valid PSNR after TRAIN_ITERS: runs that collapse the warp's affine read
# 21.89-24.86 dB there, runs that train 30.83-36.82 dB, the deterministic
# run of the default seed 34.32 dB (PERF.md section 6)
TRAIN_PSNR_FLOOR = 30.0
COMPEN_ITERS = 200            # CompenNet++ training budget of the smoke
# CompenNet++'s valid PSNR after COMPEN_ITERS deterministic iterations:
# 21.94 dB measured (untrained 10.23); predicting the mean projector image,
# where a warp that never registers converges, reads 12.10 dB (PERF.md
# section 6, PR 5)
COMPEN_PSNR_FLOOR = 18.0
STEADY_WARMUP, STEADY_STEPS = 3, 10   # re-timed training iterations
MULTI_CHECK_ITERS = 6         # multi-setup vs sequential training, [multisetup]
BENCH_REPS = 1                # [bench]: timed sweeps of the 3 classifiers
BENCH_TRAIN_ITERS = 400       # [bench]: end-to-end training iterations


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
    # the bench's inference chain launches the forward at B = 11
    x11 = x[:11].contiguous()
    check_kernel(warp, x11, dout[:11].contiguous(), "main grid")
    x11_nchw = x11.permute(0, 3, 1, 2).contiguous()
    grid11 = cache.fine_grid.expand(11, -1, -1, -1)
    b11 = warp_bounds(warp, 11, 3)["fwd"]
    with torch.no_grad():
        med, lo, hi = cuda_ms(lambda: W.warp_forward(warp, x11))
        plain11 = cuda_ms(lambda: W.warp_forward_plain(warp, x11),
                          launches=3, runs=3)[0]
        lib11 = cuda_ms(lambda: F.grid_sample(
            x11_nchw, grid11, mode="bilinear", padding_mode="zeros",
            align_corners=True) * mask)[0]
    log(f"[kernels] fixed_warp_fwd at B=11 (the bench's inference batch): "
        f"kernel={med:.4f} ms (min {lo:.4f}, max {hi:.4f}) "
        f"plain={plain11:.4f} ms library={lib11:.4f} ms "
        f"bound={b11['bound_ms']:.4f} ms ({b11['bound_by']}: {b11['bytes']} "
        f"B) -> {100 * b11['bound_ms'] / med:.1f}% of bound")
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


def phase_conv_route(trained, dev):
    """The routes of ShadingNetSPAA's stride-1 3x3 convolutions
    (``ops/conv.py``): the route table filled by one no-grad forward of
    the attack's PCNet at B = 132 (``make_pcnet_fn``) and one of the model
    at training's B = 24; per key the two median times and their rates,
    both routes against each other (within 1e-5 of the output's largest
    value), the backward against ``F.conv2d``'s (the same call: within
    1e-5, bitwise unless cuDNN's weight gradient adds in another order),
    and the kernels of one call of each route, and of the input-gradient
    problem the transposed route poses, from a profile."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from spaa_tpu_torch.attack.orchestrate import make_pcnet_fn
    from spaa_tpu_torch.ops import conv

    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        make_pcnet_fn(trained)(
            torch.rand((132, 256, 256, 3), generator=gen, device=dev))
        trained.model(torch.rand((24, 256, 256, 3), generator=gen,
                                 device=dev), trained.cam_scene, trained.mask)
    torch.cuda.synchronize()
    for c in conv.choices():
        n, cin, h, w = c["x"]
        cout = c["weight"][0]
        tflop = 2 * n * h * w * cout * cin * 9 / 1e12
        x = torch.rand(c["x"], generator=gen, device=dev)
        wt = (torch.rand(c["weight"], generator=gen, device=dev) - 0.5) \
            / (3 * cin ** 0.5)
        b = torch.rand((cout,), generator=gen, device=dev) - 0.5
        for t in (x, wt, b):
            t.requires_grad_(True)
        outs = {r: conv.Conv3x3S1.apply(x, wt, b, r) for r in conv.ROUTES}
        err = float((outs["direct"] - outs["transposed"]).detach().abs().max()
                    / outs["direct"].detach().abs().max())
        gy = torch.randn(outs["direct"].shape, generator=gen, device=dev)
        ref = torch.autograd.grad(F.conv2d(x, wt, b, 1, 1), (x, wt, b), gy)
        grads = torch.autograd.grad(outs["transposed"], (x, wt, b), gy)
        same = all(bool(torch.equal(u, v)) for u, v in zip(grads, ref))
        gerr = max(float((u - v).abs().max() / v.abs().max())
                   for u, v in zip(grads, ref))
        # the input-gradient problem the transposed route hands cuDNN, as
        # a pullback poses it: gradient x, weight [Cin, Cout, 3, 3]
        wd = wt.detach().flip(2, 3).transpose(0, 1).contiguous()
        like = torch.empty((n, cout, h, w), device=dev)
        calls = {r: (lambda r=r: conv.FORWARD[r](x, wt, b))
                 for r in conv.ROUTES}
        calls["as a pullback"] = lambda: torch.ops.aten.convolution_backward(
            x, like, wd, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, False, False])
        names = {}
        with torch.no_grad():
            for r, call in calls.items():
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                names[r] = "; ".join(
                    f"{e.key[:90]} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in sorted(prof.key_averages(),
                                    key=lambda e: -e.self_device_time_total)
                    if e.self_device_time_total > 0)
        log(f"[conv_route] x {c['x']} weight {c['weight']} {c['dtype']}: "
            f"{c['route']}; direct {c['direct_ms']:.4f} ms "
            f"({tflop / c['direct_ms'] * 1e3:.2f} TFLOP/s), transposed "
            f"{c['transposed_ms']:.4f} ms "
            f"({tflop / c['transposed_ms'] * 1e3:.2f} TFLOP/s); routes "
            f"apart {err:.3e}; backward against F.conv2d's {gerr:.3e} "
            f"(bitwise equal: {same})")
        for r, ks in names.items():
            log(f"[conv_route]   {r} kernels: {ks or 'none recorded'}")
        if not err <= 1e-5:
            raise AssertionError(f"conv routes differ by {err:.3e} at {c}")
        if not gerr <= 1e-5:
            raise AssertionError(f"the routed backward differs from "
                                 f"F.conv2d's by {gerr:.3e} at {c}")
    log(f"[conv_route] choices {json.dumps(conv.choices())}")


def steady_ms_per_iter(cfg, pcnet_apply, clf, cam_scene, target_idx,
                       true_idx, info, dev, iters=5):
    """ms per SPAA iteration on the warm path: the sweep's batch re-run
    for ``iters`` iterations, host clock around synchronised calls."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.attack.spaa import spaa_attack_batched

    cp_sz = tuple(int(v) for v in info["classifier_crop_sz"])
    (_, _, prj_init, tgt, targeted, w, dt,
     scfg) = O.build_spaa_sweep_arrays(cfg, info, target_idx, true_idx)

    def tt(a, dtype=torch.float32):
        return torch.from_numpy(a).to(dev, dtype)

    args = (pcnet_apply,
            O.make_attack_logits_fn(clf, cp_sz, cfg.get("attack_dtype")),
            cam_scene,
            tt(prj_init), tt(tgt, torch.long), tt(targeted, torch.bool),
            tt(w), tt(dt), scfg._replace(iters=iters))
    torch.cuda.synchronize()
    t0 = time.time()
    spaa_attack_batched(*args)
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t0) / iters


def phase_main_path(cfg, trained, dev):
    """The SPAA sweep of one setup: every (stealth loss x d_thr) config of
    ``cfg`` x 11 samples as one batch, ``cfg.attack_iters`` iterations."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.models.classifiers import (Classifier,
                                                   load_imagenet_labels)
    from spaa_tpu_torch.ops import conv
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
    conv.reset_launch_counts()
    t0 = time.time()
    cam_best, prj_best = O._run_spaa_sweep(
        cfg, trained, clf, cam_scene, target_idx, true_idx, info, setup_path,
        cfg_str, "resnet18")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(W.LAUNCHES)
    conv_routes = dict(conv.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    n_png = count_pngs(setup_path)
    ok_out = all(bool(torch.isfinite(t).all()) and float(t.min()) >= 0.0
                 and float(t.max()) <= 1.0 for t in (cam_best, prj_best))
    log(f"[main] sweep: {wall:.3f} s wall ({wall / n_cfg:.3f} s/config) "
        f"for {cam_best.shape[0]} images x {iters} iterations; peak memory "
        f"{peak / 2**30:.3f} GiB; {n_png} PNGs; outputs finite and in "
        f"[0,1]: {ok_out}; launches {launches}; conv routes {conv_routes}")
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

    pcnet_apply = O.make_pcnet_fn(trained)
    ms_iter = steady_ms_per_iter(cfg, pcnet_apply, clf, cam_scene,
                                 target_idx, true_idx, info, dev)
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


def count_pngs(root, classifier=None, attacker_cfg=""):
    n = 0
    for sub in ("prj/adv", "cam/infer/adv"):
        for d, _, files in os.walk(join(root, sub, attacker_cfg)):
            if classifier is None or os.path.basename(d) == classifier:
                n += len(files)
    return n


def phase_sim(tmp):
    """The port's simulator writes the benchmark-size setup; its mask and
    corners must equal the committed fixture's."""
    from spaa_tpu_torch.train.data import nayar_separation
    from spaa_tpu_torch.utils.imgproc_host import threshold_im
    from spaa_tpu_torch.utils.io import imread_dir
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)
    data = join(tmp, "sim", "sim_benchmark")
    t0 = time.time()
    SimProCams(dict(DEFAULT_SIM_SETUP_INFO), seed=7).make_setup(
        data, "sim_setup", num_train=NUM_TRAIN, num_test=NUM_VALID)
    host_s = time.time() - t0

    def mask_corners(setup):
        direct, _ = nayar_separation(imread_dir(join(setup, "cam/raw/cb")))
        m, _, corners = threshold_im(direct)
        return m, corners

    m, c = mask_corners(join(data, "setups", "sim_setup"))
    m_fix, c_fix = mask_corners(join(REPO, "spaa_tpu_torch", "assets",
                                     "sim_setup"))
    same = bool((m == m_fix).all()) and c == c_fix
    log(f"[sim] SimProCams(seed=7).make_setup: {NUM_TRAIN} train + "
        f"{NUM_VALID} validation pairs in {host_s:.3f} s host time; mask "
        f"({int(m.sum())} px) and corners equal the fixture's: {same}")
    if not same:
        raise AssertionError("the port's sim setup has another mask or "
                             "other corners than the committed fixture")
    return data, host_s


def phase_train(data_root, dev):
    """train_eval_pcnet at full width on deterministic kernels; the
    checkpoint read back; then the steady-state training iteration on the
    default kernels, re-timed on a fresh model."""
    import torch
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.train.data import as_uint8_wire, load_data
    from spaa_tpu_torch.train.train import (get_model_train_cfg,
                                            make_evaluator,
                                            make_pcnet_optimizer)
    from spaa_tpu_torch.utils.seed import (reset_rng_seeds,
                                           set_reproducibility)

    mc = get_model_train_cfg(["PCNet"], data_root, ["sim_setup"])
    mc.max_iters = TRAIN_ITERS
    mc.valid_rate = VALID_RATE
    data = load_data(data_root, "sim_setup")
    scene = torch.from_numpy(data["cam_scene"]).to(dev)
    mask = torch.from_numpy(data["mask"]).to(dev)
    untrained = P._build_pcnet("PCNet", data["cam_scene"].shape[1:3],
                               data["mask_corners"],
                               reset_rng_seeds(123)).to(dev)
    psnr0 = make_evaluator(lambda x: untrained(x, scene, mask),
                           as_uint8_wire(data["prj_valid"]),
                           as_uint8_wire(data["cam_valid"]), dev)()[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    set_reproducibility(True)
    try:
        trained, table, cfg = P.train_eval_pcnet(mc, dev)
    finally:
        set_reproducibility(False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    curve = [json.loads(line) for line in open(join(
        data_root, "..", "log", "curves_PCNet_sim_setup.jsonl"))]
    psnr, rmse, ssim = table.rows[0][6:9]
    losses = [c["train_loss"] for c in curve]
    log(f"[train] train_eval_pcnet: {TRAIN_ITERS} iterations at batch "
        f"{cfg.batch_size}, {cfg.num_train} pairs, deterministic kernels, "
        f"in {wall:.3f} s wall (data load, 2 validations, final validation "
        f"of {NUM_VALID} and PNG writes included); loss {losses[0]:.5f} at iteration "
        f"{curve[0]['step']}, {losses[-1]:.5f} at {curve[-1]['step']}; "
        f"valid PSNR {psnr:.4f} RMSE {rmse:.4f} SSIM {ssim:.4f} (untrained "
        f"PSNR {psnr0:.4f}); peak memory {peak / 2**30:.3f} GiB")
    if not all(math.isfinite(v) for v in losses + [psnr, rmse, ssim]):
        raise AssertionError(f"non-finite training losses or metrics: "
                             f"{losses}, {psnr}, {rmse}, {ssim}")
    if not psnr > psnr0:
        raise AssertionError(f"training did not raise the validation PSNR "
                             f"({psnr0} -> {psnr})")
    if not psnr >= TRAIN_PSNR_FLOOR:
        raise AssertionError(f"valid PSNR {psnr} dB after {TRAIN_ITERS} "
                             f"iterations is under {TRAIN_PSNR_FLOOR} dB: "
                             f"the warp's affine collapsed")

    # the checkpoint, read back by the port's loader
    back, _ = P.load_pretrained_pcnet(mc, "sim_setup", dev)
    for k, v in trained.model.state_dict().items():
        if not torch.equal(back.model.state_dict()[k], v):
            raise AssertionError(f"checkpoint read back differs at {k}")

    # steady-state iteration: a fresh model, 10 l1 and 10 l1+ssim steps
    model = P._build_pcnet("PCNet", data["cam_scene"].shape[1:3],
                           data["mask_corners"], reset_rng_seeds(123)).to(dev)
    opt, sched = make_pcnet_optimizer(model, cfg)
    loss_fn = P.make_pcnet_loss(model, scene, mask)
    x_all = torch.from_numpy(as_uint8_wire(data["prj_train"])).to(dev)
    y_all = torch.from_numpy(as_uint8_wire(data["cam_train"])).to(dev)
    ms = {phase: steady_train_ms(loss_fn, opt, sched, x_all, y_all,
                                 cfg.batch_size, dev, itr)
          for phase, itr in (("l1", 0), ("l1+ssim", 401))}
    log(f"[train] steady state at batch {cfg.batch_size}: "
        f"{ms['l1']:.2f} ms/iteration (l1, iterations <= 400), "
        f"{ms['l1+ssim']:.2f} ms/iteration (l1+ssim), median of "
        f"{STEADY_STEPS}")
    return dict(wall_s=wall, ms_l1=ms["l1"], ms_l1_ssim=ms["l1+ssim"],
                peak_bytes=peak, psnr=psnr, psnr0=psnr0)


def phase_attack(data_root, dev, classifier, attack_dtype=None, tag="main"):
    """run_projector_based_attack with load_pretrained on the trained
    checkpoint: one classifier's full sweep (``attack_dtype``: the
    config's compute type, float32 if None); the sweep itself is timed
    and its outputs checked through a wrapper of ``_run_spaa_sweep``."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.ops import warp as W

    cfg = O.get_attacker_cfg("SPAA", data_root, ["sim_setup"],
                             load_pretrained=True)
    cfg.classifier_names = [classifier]
    cfg.attack_iters = ITERS
    cfg.max_iters = TRAIN_ITERS
    if attack_dtype is not None:
        cfg.attack_dtype = attack_dtype
    n_cfg = len(cfg.stealth_losses) * len(cfg.d_threshes)
    seen = {}
    orig = O._run_spaa_sweep

    def timed_sweep(cfg_, trained, clf, *args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        W.reset_launch_counts()
        t0 = time.time()
        out = orig(cfg_, trained, clf, *args)
        torch.cuda.synchronize()
        seen.update(wall=time.time() - t0, launches=dict(W.LAUNCHES),
                    peak=torch.cuda.max_memory_allocated(), out=out,
                    trained=trained, clf=clf, args=args)
        return out

    O._run_spaa_sweep = timed_sweep
    try:
        O.run_projector_based_attack(cfg, weights_dir=join(REPO,
                                                           "checkpoint"),
                                     device=dev)
    finally:
        O._run_spaa_sweep = orig
    cam_best, prj_best = seen["out"]
    launches, wall = seen["launches"], seen["wall"]
    setup_path = join(data_root, "setups", "sim_setup")
    n_png = count_pngs(setup_path, classifier,
                       O.to_attacker_cfg_str("SPAA")[0])
    ok_out = all(bool(torch.isfinite(t).all()) and float(t.min()) >= 0.0
                 and float(t.max()) <= 1.0 for t in (cam_best, prj_best))
    clf = seen["clf"]
    src = ("torchvision .pth" if clf.loaded_pretrained
           else "deterministic init, seed 0")

    (cam_scene, target_idx, true_idx, info) = seen["args"][:4]
    ms_iter = steady_ms_per_iter(
        cfg, O.make_pcnet_fn(seen["trained"], cfg.get("attack_dtype")), clf,
        cam_scene, target_idx, true_idx, info, dev)
    b = 11 * n_cfg
    log(f"[{tag}] {classifier} ({src}, input {clf.input_sz[0]}x"
        f"{clf.input_sz[1]}, {cfg.get('attack_dtype', 'float32')}): "
        f"sweep {wall:.3f} s wall ({wall / n_cfg:.3f} "
        f"s/config) for {cam_best.shape[0]} images x {ITERS} iterations; "
        f"steady state {ms_iter:.2f} ms/iteration; peak memory "
        f"{seen['peak'] / 2**30:.3f} GiB; {n_png} PNGs; outputs finite and "
        f"in [0,1]: {ok_out}; launches {launches}")
    if cam_best.shape[0] != b or prj_best.shape[0] != b:
        raise AssertionError(f"unexpected batch {cam_best.shape[0]}")
    if not ok_out:
        raise AssertionError(f"{classifier} sweep outputs are not finite in "
                             "[0, 1]")
    if n_png != 2 * b:
        raise AssertionError(f"expected {2 * b} PNGs for {classifier}, "
                             f"found {n_png}")
    for k in ("fixed_warp_fwd", "fixed_warp_bwd"):
        if launches[k] != ITERS:
            raise AssertionError(f"{k} launched {launches[k]} times in the "
                                 f"{classifier} sweep, expected {ITERS}")
    return dict(wall_s=wall, s_per_config=wall / n_cfg, ms_per_iter=ms_iter,
                peak_bytes=seen["peak"], launches=launches,
                cam_best=cam_best, clf=clf, cp_sz=info["classifier_crop_sz"])


def steady_train_ms(loss_fn, opt, sched, x_all, y_all, batch, dev, itr=0):
    """Median ms of STEADY_STEPS synchronised training steps (``loss_fn``
    at iteration ``itr``) on random minibatches, after STEADY_WARMUP (host
    clock, default kernels)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    times = []
    for k in range(STEADY_WARMUP + STEADY_STEPS):
        idx = torch.randint(0, x_all.shape[0], (batch,), generator=gen,
                            device=dev)
        x, y = (a[idx].float() / 255.0 if a.dtype == torch.uint8 else a[idx]
                for a in (x_all, y_all))
        torch.cuda.synchronize()
        t1 = time.time()
        loss, _ = loss_fn(x, y, itr)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        torch.cuda.synchronize()
        if k >= STEADY_WARMUP:
            times.append(1e3 * (time.time() - t1))
    return statistics.median(times)


def phase_compennet(data_root, dev):
    """train_eval_compennet_pp at full width on deterministic kernels:
    CompenNet's pre-training at its default 500 iterations (batch 48),
    CompenNet++ at COMPEN_ITERS (batch 24); the checkpoint read back; the
    validation PSNR against the untrained CompenNet++'s; then each model's
    steady-state iteration re-timed on the default kernels."""
    import numpy as np
    import torch
    from spaa_tpu_torch.models.compen_net import CompenNetPlusplus
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.train.data import as_uint8_wire, load_data
    from spaa_tpu_torch.train.train import (get_model_train_cfg,
                                            make_compennet_pp_optimizer,
                                            make_evaluator)
    from spaa_tpu_torch.utils.io import imread_dir
    from spaa_tpu_torch.utils.seed import (reset_rng_seeds,
                                           set_reproducibility)

    mc = get_model_train_cfg(["CompenNet++"], data_root, ["sim_setup"])
    mc.max_iters = COMPEN_ITERS
    mc.valid_rate = VALID_RATE
    seen = {}
    orig = P.init_compennet

    def timed_init(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        seen["init_s"] = time.time() - t0
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    P.init_compennet = timed_init
    set_reproducibility(True)
    try:
        trained, table, cfg = P.train_eval_compennet_pp(mc, dev)
    finally:
        P.init_compennet = orig
        set_reproducibility(False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    curve = [json.loads(line) for line in open(join(
        data_root, "..", "log", "curves_CompenNet++_sim_setup.jsonl"))]
    psnr, rmse, ssim = table.rows[0][6:9]
    losses = [c["train_loss"] for c in curve]

    # the untrained CompenNet++: the pipeline's draw, inverse affine and
    # pre-trained CompenNet (now cached), before any CompenNet++ step
    data = load_data(data_root, "sim_setup")
    scene = torch.from_numpy(data["cam_scene"]).to(dev)
    prj_hw = data["prj_train"].shape[1:3]
    compen = P.init_compennet(data_root, mc, dev)
    untrained = P._set_affine(CompenNetPlusplus(prj_hw).init_weights(
        reset_rng_seeds(0)), data["mask_corners"], inverse=True)
    untrained.compen_net.load_state_dict(compen.state_dict())
    untrained = untrained.to(dev)
    psnr0 = make_evaluator(lambda x: untrained(x, scene),
                           as_uint8_wire(data["cam_valid"]),
                           as_uint8_wire(data["prj_valid"]), dev)()[0]
    log(f"[compennet] CompenNet pre-training: 500 iterations at batch 48 on "
        f"{NUM_TRAIN} pairs in {seen['init_s']:.3f} s (image reads "
        f"included), deterministic kernels")
    log(f"[compennet] train_eval_compennet_pp: {COMPEN_ITERS} iterations at "
        f"batch {cfg.batch_size}, {cfg.num_train} pairs, deterministic "
        f"kernels, in {wall - seen['init_s']:.3f} s wall after the "
        f"pre-training (data load, 2 validations, final validation of "
        f"{NUM_VALID} and PNG writes included); loss {losses[0]:.5f} at "
        f"iteration {curve[0]['step']}, {losses[-1]:.5f} at "
        f"{curve[-1]['step']}; valid PSNR {psnr:.4f} RMSE {rmse:.4f} SSIM "
        f"{ssim:.4f} (untrained PSNR {psnr0:.4f}); peak memory "
        f"{peak / 2**30:.3f} GiB")
    if not all(math.isfinite(v) for v in losses + [psnr, rmse, ssim]):
        raise AssertionError(f"non-finite CompenNet++ losses or metrics: "
                             f"{losses}, {psnr}, {rmse}, {ssim}")
    if not psnr > psnr0:
        raise AssertionError(f"training did not raise CompenNet++'s "
                             f"validation PSNR ({psnr0} -> {psnr})")
    if not psnr >= COMPEN_PSNR_FLOOR:
        raise AssertionError(f"CompenNet++ valid PSNR {psnr} dB after "
                             f"{COMPEN_ITERS} iterations is under "
                             f"{COMPEN_PSNR_FLOOR} dB")

    back = P._load_weights(CompenNetPlusplus(prj_hw), P._ckpt_path(cfg))
    for k, v in trained.model.state_dict().items():
        if not torch.equal(back.state_dict()[k].to(dev), v):
            raise AssertionError(f"CompenNet++ checkpoint read back differs "
                                 f"at {k}")

    # steady state on the default kernels: the pre-training's step (batch
    # 48, float pairs) and CompenNet++'s (batch 24, uint8 pairs)
    init_scene = imread_dir(join(data_root, "prj_share/init"))[:1]
    prj = torch.from_numpy(data["prj_train"]).to(dev)
    cam_init = torch.from_numpy(np.abs(data["prj_train"]
                                       - 0.3 * init_scene)).to(dev)
    ms = {}
    for name, model, loss_fn, x_all, y_all, batch in (
            ("CompenNet", compen.train(), P.make_compennet_loss(
                compen, torch.from_numpy(init_scene).to(dev), "l1+ssim"),
             cam_init, prj, 48),
            ("CompenNet++", untrained.train(), P.make_compennet_loss(
                untrained, scene, "l1+ssim"),
             torch.from_numpy(as_uint8_wire(data["cam_train"])).to(dev),
             torch.from_numpy(as_uint8_wire(data["prj_train"])).to(dev),
             24)):
        opt, sched = make_compennet_pp_optimizer(model, mc)
        ms[name] = steady_train_ms(loss_fn, opt, sched, x_all, y_all, batch,
                                   dev)
    log(f"[compennet] steady state: CompenNet pre-training "
        f"{ms['CompenNet']:.2f} ms/iteration at batch 48, CompenNet++ "
        f"{ms['CompenNet++']:.2f} ms/iteration at batch 24 (l1+ssim), "
        f"median of {STEADY_STEPS}")
    return dict(init_s=seen["init_s"], wall_s=wall, psnr=psnr, psnr0=psnr0,
                ms_init=ms["CompenNet"], ms_pp=ms["CompenNet++"],
                peak_bytes=peak)


# the [multisetup] root's second setup, written by a child process
SIM2_CHILD = """
import sys, time
from spaa_tpu_torch.utils.sim_procams import DEFAULT_SIM_SETUP_INFO, SimProCams
t0 = time.time()
SimProCams(dict(DEFAULT_SIM_SETUP_INFO), seed=20).make_setup(
    sys.argv[1], "sim_setup_2", num_train=int(sys.argv[2]),
    num_test=int(sys.argv[3]))
print(f"{time.time() - t0:.3f}")
"""


def start_multisetup_root(sim_root, tmp):
    """The ``[multisetup]`` data root, begun right after ``[sim]`` so that
    the second setup's host-bound generation overlaps ``[train]`` and
    ``[compennet]`` on the card: a copy of the ``[sim]`` root
    (``sim_setup``, the shared projector images, the labels), and a child
    process writing ``sim_setup_2`` with the port's ``SimProCams(seed=20)``
    (seeds 7 + 13 k, the ``--num-sim-setups`` rule). Returns the root and
    the child."""
    root = join(tmp, "multi", "sim_benchmark")
    shutil.copytree(sim_root, root)
    child = subprocess.Popen(
        [sys.executable, "-c", SIM2_CHILD, root, str(NUM_TRAIN),
         str(NUM_VALID)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    return root, child


def finish_multisetup_root(root, child, sim_root):
    """Wait for ``sim_setup_2``; copy CompenNet's pre-training checkpoint
    from the ``[compennet]`` root."""
    from spaa_tpu_torch.train.pipeline import INIT_CKPT_NAME
    t0 = time.time()
    try:
        out, err = child.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise
    if child.returncode != 0:
        raise AssertionError(f"SimProCams(seed=20) child failed "
                             f"({child.returncode}): {err[-2000:]}")
    ckpt_dir = join(dirname(root), "checkpoint")
    os.makedirs(ckpt_dir)
    init_ckpt = join(ckpt_dir, INIT_CKPT_NAME + ".flax")
    shutil.copy2(join(sim_root, "..", "checkpoint", INIT_CKPT_NAME + ".flax"),
                 init_ckpt)
    log(f"[multisetup] SimProCams(seed=20).make_setup(sim_setup_2), a child "
        f"process started after [sim]: {NUM_TRAIN} train + {NUM_VALID} "
        f"validation pairs in {float(out.split()[-1]):.3f} s host time, "
        f"{time.time() - t0:.3f} s waited for here; sim_setup copied from "
        f"the [sim] root, CompenNet's pre-training checkpoint from the "
        f"[compennet] root")
    return ckpt_dir, init_ckpt


def draw_model(d, dev, model_name, compen=None):
    """A setup's initial model as its pipeline draws it: PCNet under
    reseed 123 (``train_eval_pcnet``), CompenNet++ under reseed 0 with
    the inverse affine and the pre-trained CompenNet spliced in
    (``train_eval_compennet_pp``)."""
    from spaa_tpu_torch.models.compen_net import CompenNetPlusplus
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.utils.seed import reset_rng_seeds
    if model_name == "PCNet":
        return P._build_pcnet("PCNet", d["cam_scene"].shape[1:3],
                              d["mask_corners"],
                              reset_rng_seeds(123)).to(dev)
    net = P._set_affine(CompenNetPlusplus(
        d["prj_train"].shape[1:3]).init_weights(reset_rng_seeds(0)),
        d["mask_corners"], inverse=True)
    net.compen_net.load_state_dict(compen.state_dict())
    return net.to(dev)


def multi_vs_sequential(datas, dev, mc, mc2, root, ms_seq):
    """MULTI_CHECK_ITERS iterations of the two setups in one call of each
    multi-setup trainer against two sequential ``train_model`` runs with
    the pipelines' losses and optimizers, from the same initial draws and
    minibatch plan, float32 on deterministic kernels, held to rtol 1e-3;
    then the two-setup PCNet call re-timed on the default kernels."""
    import numpy as np
    import torch
    from spaa_tpu_torch.models.compen_net import CompenNetPlusplus
    from spaa_tpu_torch.models.pcnet import PCNet
    from spaa_tpu_torch.parallel import (train_compennet_pp_multi_setup,
                                         train_pcnet_multi_setup)
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.train.data import as_uint8_wire
    from spaa_tpu_torch.train.train import (make_compennet_pp_optimizer,
                                            make_pcnet_optimizer,
                                            sample_batch_indices,
                                            train_model)
    from spaa_tpu_torch.utils.config import DictConfig
    from spaa_tpu_torch.utils.seed import set_reproducibility

    compen = P.init_compennet(root, mc2, dev)
    prj = [as_uint8_wire(d["prj_train"]) for d in datas]
    cam = [as_uint8_wire(d["cam_train"]) for d in datas]
    scenes = np.stack([d["cam_scene"] for d in datas])

    def multi(model_name, iters):
        models = [draw_model(d, dev, model_name, compen) for d in datas]
        idx = sample_batch_indices(NUM_TRAIN, 24, iters)
        sds = [m.state_dict() for m in models]
        if model_name == "PCNet":
            return train_pcnet_multi_setup(
                PCNet(out_size=tuple(datas[0]["cam_scene"].shape[1:3])), sds,
                lambda m: make_pcnet_optimizer(m, mc), scenes,
                np.stack([d["mask"] for d in datas]), np.stack(prj),
                np.stack(cam), idx, curriculum_iter=400)
        return train_compennet_pp_multi_setup(
            CompenNetPlusplus(tuple(datas[0]["prj_train"].shape[1:3])), sds,
            lambda m: make_compennet_pp_optimizer(m, mc2), scenes,
            np.stack(cam), np.stack(prj), idx)

    n = MULTI_CHECK_ITERS
    set_reproducibility(True)
    try:
        for model_name in ("PCNet", "CompenNet++"):
            t0 = time.time()
            _, losses, _ = multi(model_name, n)
            seq = []
            for s, d in enumerate(datas):
                model = draw_model(d, dev, model_name, compen)
                idx = sample_batch_indices(NUM_TRAIN, 24, n)
                scene = torch.from_numpy(d["cam_scene"]).to(dev)
                if model_name == "PCNet":
                    opt, sched = make_pcnet_optimizer(model, mc)
                    loss_fn = P.make_pcnet_loss(
                        model, scene, torch.from_numpy(d["mask"]).to(dev))
                    arrays = dict(inputs=prj[s], targets=cam[s])
                else:
                    opt, sched = make_compennet_pp_optimizer(model, mc2)
                    loss_fn = P.make_compennet_loss(model, scene, "l1+ssim")
                    arrays = dict(inputs=cam[s], targets=prj[s])
                curve = []
                train_model(loss_fn, model, opt, sched, arrays, idx,
                            DictConfig(dict(max_iters=n, valid_rate=n)), dev,
                            log_prefix="[multisetup]   ", step_losses=curve)
                seq.append([c[0] for c in curve])
            seq = np.asarray(seq, np.float32).T
            per_iter = np.max(np.abs(losses - seq) / np.abs(seq), axis=1)
            rel = float(per_iter.max())
            log(f"[multisetup] {model_name}: {n} iterations of 2 setups in "
                f"one call on {dev} vs two sequential train_model runs, "
                f"float32, deterministic kernels, {time.time() - t0:.3f} s: "
                f"losses {losses.tolist()} sequential {seq.tolist()}; "
                f"max relative difference {rel:.3e} (tolerance 1e-3), "
                f"bitwise equal: {bool(np.array_equal(losses, seq))}")
            if not rel <= 1e-3:
                raise AssertionError(f"{model_name}: the multi-setup and "
                                     f"sequential losses differ by {rel} "
                                     f"(relative)")
    finally:
        set_reproducibility(False)
    # steady state: two calls that differ by 10 iterations
    walls = []
    for iters in (3, 13):
        torch.cuda.synchronize()
        t0 = time.time()
        multi("PCNet", iters)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    ms_multi = 1e3 * (walls[1] - walls[0]) / 10
    log(f"[multisetup] steady state, default kernels, batch 24 a setup: "
        f"{ms_multi:.2f} ms per iteration of 2 setups (calls of 13 and 3 "
        f"iterations, {walls[1]:.3f} - {walls[0]:.3f} s, over 10) vs 2 x "
        f"{ms_seq:.2f} = {2 * ms_seq:.2f} ms sequential ([train], l1)")
    return ms_multi


def untrained_psnr(datas, dev, model_name, data_root, mc):
    """Each setup's validation PSNR before training, from the pipeline's
    own initial draw."""
    import torch
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.train.data import as_uint8_wire
    from spaa_tpu_torch.train.train import make_evaluator
    compen = None if model_name == "PCNet" else \
        P.init_compennet(data_root, mc, dev)
    out = []
    for d in datas:
        scene = torch.from_numpy(d["cam_scene"]).to(dev)
        net = draw_model(d, dev, model_name, compen)
        if model_name == "PCNet":
            mask = torch.from_numpy(d["mask"]).to(dev)
            ev = make_evaluator(lambda x: net(x, scene, mask),
                                as_uint8_wire(d["prj_valid"]),
                                as_uint8_wire(d["cam_valid"]), dev)
        else:
            ev = make_evaluator(lambda x: net(x, scene),
                                as_uint8_wire(d["cam_valid"]),
                                as_uint8_wire(d["prj_valid"]), dev)
        out.append(ev()[0])
    return out


def fill_cache(fill, mc, names, dev, psnr0, what, psnr_train=None):
    """One cache filler at chunk 2: both setups trained, each PSNR above
    its untrained model's; a second call finds both cached."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rows = fill(mc, chunk=2, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    beside = "" if psnr_train is None else \
        f" ([train]'s one setup on deterministic kernels: {psnr_train:.4f})"
    log(f"[multisetup] {what}: {mc.max_iters} iterations of 2 setups, "
        f"one after the other at batch 24, default kernels, {wall:.3f} s "
        f"wall (data load, validation and checkpoints included); peak memory "
        f"{peak / 2**30:.3f} GiB; " + "; ".join(
            f"{r['setup']} {r['status']} valid PSNR {r.get('PSNR', 0):.4f} "
            f"RMSE {r.get('RMSE', 0):.4f} SSIM {r.get('SSIM', 0):.4f} "
            f"(untrained {p0:.4f})" for r, p0 in zip(rows, psnr0)) + beside)
    if [r["status"] for r in rows] != ["trained", "trained"] or \
            [r["setup"] for r in rows] != names:
        raise AssertionError(f"{what}: {rows}")
    for r, p0 in zip(rows, psnr0):
        if not (math.isfinite(r["PSNR"]) and r["PSNR"] > p0):
            raise AssertionError(f"{what}: {r['setup']} valid PSNR "
                                 f"{r['PSNR']} is not above the untrained "
                                 f"{p0}")
    again = fill(mc, chunk=2, device=dev)
    log(f"[multisetup] {what} again: {[r['status'] for r in again]}")
    if [r["status"] for r in again] != ["cached", "cached"]:
        raise AssertionError(f"{what} second call: {again}")
    return dict(wall_s=wall, peak_bytes=peak, rows=rows)


def mtimes(ckpt_dir):
    return {f: os.path.getmtime(join(ckpt_dir, f))
            for f in sorted(os.listdir(ckpt_dir)) if f.endswith(".flax")}


def multisetup_waves(root, names, dev, ckpt_dir):
    """``run_spaa_attack_multi_setup`` (ResNet-18, the full sweep, ITERS
    iterations) and ``run_percal_attack_multi_setup`` (ResNet-18, camdE /
    11) with ``load_pretrained`` on one card: waves of one, each setup's
    sweep timed through a wrapper of the sequential program it runs; the
    launch counts are set to 0 just before each driver and read just
    after it. The checkpoints must load, not retrain."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.ops import warp as W
    from spaa_tpu_torch.parallel import (run_percal_attack_multi_setup,
                                         run_spaa_attack_multi_setup)
    before = mtimes(ckpt_dir)
    out = {}
    for attacker, driver, sweep in (
            ("SPAA", run_spaa_attack_multi_setup, "_run_spaa_sweep"),
            ("PerC-AL+CompenNet++", run_percal_attack_multi_setup,
             "_run_percal_sweep")):
        cfg = O.get_attacker_cfg(attacker, root, names, load_pretrained=True)
        cfg.classifier_names = ["resnet18"]
        cfg.attack_iters = ITERS
        cfg.max_iters = TRAIN_ITERS if attacker == "SPAA" else COMPEN_ITERS
        n_cfg = len(cfg.stealth_losses) * len(cfg.d_threshes)
        seen = []
        orig = getattr(O, sweep)

        def timed(cfg_, trained, clf, cam_scene, *args, _orig=orig,
                  _seen=seen):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            l0 = dict(W.LAUNCHES)
            t0 = time.time()
            res = _orig(cfg_, trained, clf, cam_scene, *args)
            torch.cuda.synchronize()
            _seen.append(dict(
                wall=time.time() - t0, out=res,
                launches={k: W.LAUNCHES[k] - l0[k] for k in l0},
                peak=torch.cuda.max_memory_allocated()))
            return res

        setattr(O, sweep, timed)
        torch.cuda.synchronize()
        W.reset_launch_counts()
        t0 = time.time()
        try:
            driver(cfg, mesh=None, weights_dir=join(REPO, "checkpoint"),
                   device=dev)
        finally:
            setattr(O, sweep, orig)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(W.LAUNCHES)
        if len(seen) != len(names):
            raise AssertionError(f"{attacker}: {len(seen)} sweeps for "
                                 f"{len(names)} setups")
        cfg_str = O.to_attacker_cfg_str(attacker)[0]
        for name, s in zip(names, seen):
            cam, prj = s["out"]
            n_png = count_pngs(join(root, "setups", name), "resnet18",
                               cfg_str)
            ok_out = all(bool(torch.isfinite(t).all())
                         and float(t.min()) >= 0.0 and float(t.max()) <= 1.0
                         for t in (cam, prj))
            log(f"[multisetup] {attacker} wave of one, {name}: "
                f"{s['wall']:.3f} s wall ({s['wall'] / n_cfg:.3f} s/config) "
                f"for {cam.shape[0]} images x {ITERS} iterations; peak memory "
                f"{s['peak'] / 2**30:.3f} GiB; {n_png} PNGs; outputs finite "
                f"and in [0,1]: {ok_out}; launches {s['launches']}")
            want = ITERS if attacker == "SPAA" else 0
            if n_png != 2 * 11 * n_cfg or not ok_out or \
                    any(v != want for v in s["launches"].values()):
                raise AssertionError(f"{attacker} wave, {name}: {n_png} "
                                     f"PNGs, outputs in [0, 1] {ok_out}, "
                                     f"launches {s['launches']}")
        log(f"[multisetup] {attacker} driver: {wall:.3f} s wall for "
            f"{len(names)} setups (checkpoints loaded, classifier built, "
            f"PNGs written); launches {launches}")
        out[attacker] = dict(wall_s=wall, launches=launches, sweeps=seen)
    after = mtimes(ckpt_dir)
    if after != before:
        raise AssertionError(f"the wave drivers retrained: {before} -> "
                             f"{after}")
    return out


def phase_multisetup(root, child, sim_root, dev, train_res):
    """Setup-parallel training and attack waves at full width on ``root``
    (:func:`start_multisetup_root`): the two trainers' calls of two setups
    against two sequential runs each, the two cache fillers at chunk 2, then the SPAA and
    PerC-AL wave drivers; the multi-device path runs only on a machine
    with more than one card."""
    import torch
    from spaa_tpu_torch.parallel import (pretrain_compennets_pp_multi_setup,
                                         pretrain_pcnets_multi_setup)
    from spaa_tpu_torch.train.data import load_data
    from spaa_tpu_torch.train.train import get_model_train_cfg

    t_phase = time.time()
    names = ["sim_setup", "sim_setup_2"]
    ckpt_dir, init_ckpt = finish_multisetup_root(root, child, sim_root)
    init_mtime = os.path.getmtime(init_ckpt)
    datas = [load_data(root, n) for n in names]
    mc = get_model_train_cfg(["PCNet"], root, names)
    mc.max_iters = TRAIN_ITERS
    mc.valid_rate = VALID_RATE
    mc2 = get_model_train_cfg(["CompenNet++"], root, names)
    mc2.max_iters = COMPEN_ITERS
    mc2.valid_rate = VALID_RATE
    ms_multi = multi_vs_sequential(datas, dev, mc, mc2, root,
                                   train_res["ms_l1"])
    pc = fill_cache(pretrain_pcnets_multi_setup, mc, names, dev,
                    untrained_psnr(datas, dev, "PCNet", root, mc),
                    "pretrain_pcnets_multi_setup", train_res["psnr"])
    cp = fill_cache(pretrain_compennets_pp_multi_setup, mc2, names, dev,
                    untrained_psnr(datas, dev, "CompenNet++", root, mc2),
                    "pretrain_compennets_pp_multi_setup")
    del datas
    waves = multisetup_waves(root, names, dev, ckpt_dir)
    if os.path.getmtime(init_ckpt) != init_mtime or \
            sum(f.startswith("init_") for f in os.listdir(ckpt_dir)) != 1:
        raise AssertionError("CompenNet's pre-training ran again")
    log("[multisetup] CompenNet's pre-training checkpoint unchanged (loaded, "
        "not re-trained)")
    n_dev = torch.cuda.device_count()
    if n_dev == 1:
        log("[multisetup] the multi-device path (one setup per card, a "
            "host thread each) is not run: 1 card")
    else:
        multisetup_multi_device(root, names, n_dev)
    log(f"[multisetup] phase {time.time() - t_phase:.3f} s wall")
    return dict(ms_multi=ms_multi, pcnet=pc, compennet=cp, waves=waves)


def multisetup_multi_device(root, names, n_dev):
    """With more than one card: both wave drivers again on a mesh of every
    card, into a copy of the data root, against the one-card outputs
    (decoded PNGs within 1 count)."""
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.parallel import (make_mesh,
                                         run_percal_attack_multi_setup,
                                         run_spaa_attack_multi_setup)
    from spaa_tpu_torch.utils.io import imread_u8
    copy_root = join(dirname(dirname(root)), "multi_device", "sim_benchmark")
    shutil.copytree(dirname(root), dirname(copy_root),
                    ignore=shutil.ignore_patterns("adv"))
    mesh = make_mesh(min(n_dev, len(names)), axis="setup")
    t0 = time.time()
    for attacker, driver in (("SPAA", run_spaa_attack_multi_setup),
                             ("PerC-AL+CompenNet++",
                              run_percal_attack_multi_setup)):
        cfg = O.get_attacker_cfg(attacker, copy_root, names,
                                 load_pretrained=True)
        cfg.classifier_names = ["resnet18"]
        cfg.attack_iters = ITERS
        cfg.max_iters = TRAIN_ITERS if attacker == "SPAA" else COMPEN_ITERS
        driver(cfg, mesh=mesh, weights_dir=join(REPO, "checkpoint"))
    worst, n = 0, 0
    for d, _, files in os.walk(join(root, "setups")):
        if "adv" not in d.split(os.sep):
            continue
        for f in files:
            a = imread_u8(join(d, f)).astype(int)
            b = imread_u8(join(d.replace(root, copy_root), f)).astype(int)
            worst, n = max(worst, int(abs(a - b).max())), n + 1
    log(f"[multisetup] multi-device waves on {mesh.size} cards: "
        f"{time.time() - t0:.3f} s; {n} PNGs against the one-card run, max "
        f"difference {worst} counts")
    if worst > 1:
        raise AssertionError(f"multi-device waves differ by {worst} counts")


def phase_percal(data_root, dev):
    """run_projector_based_attack for PerC-AL+CompenNet++ with
    load_pretrained on the CompenNet++ just trained: the three
    classifiers, ITERS iterations each; each sweep timed through a
    wrapper of ``_run_percal_sweep``; no warp launch."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.attack.perc_al import PerC_AL
    from spaa_tpu_torch.ops import warp as W

    cfg = O.get_attacker_cfg("PerC-AL+CompenNet++", data_root, ["sim_setup"],
                             load_pretrained=True)
    cfg.attack_iters = ITERS
    cfg.max_iters = COMPEN_ITERS
    pcfg = O.to_attacker_cfg_str("PerC-AL+CompenNet++")[0]
    setup_path = join(data_root, "setups", "sim_setup")
    seen = {}
    orig = O._run_percal_sweep

    def timed_sweep(cfg_, trained, clf, cam_scene, target_idx, true_idx,
                    *args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        W.reset_launch_counts()
        t0 = time.time()
        out = orig(cfg_, trained, clf, cam_scene, target_idx, true_idx, *args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(W.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        # steady state: the same batch re-attacked for 5 iterations
        cp_sz = tuple(int(v) for v in trained.setup_info[
            "classifier_crop_sz"])
        inputs = cam_scene.expand(len(target_idx) + 1, -1, -1, -1)
        targeted = [True] * len(target_idx) + [False]
        logits_fn = O.make_attack_logits_fn(clf, cp_sz)
        torch.cuda.synchronize()
        t1 = time.time()
        PerC_AL(max_iterations=5, confidence=40).adversary_projector(
            logits_fn, inputs, list(target_idx) + [true_idx], d_thr=11,
            targeted=targeted, verbose=False)
        torch.cuda.synchronize()
        seen[clf.name] = dict(wall_s=wall, launches=launches, peak=peak,
                              before=before, out=out,
                              ms_iter=1e3 * (time.time() - t1) / 5)
        return out

    O._run_percal_sweep = timed_sweep
    try:
        O.run_projector_based_attack(cfg, weights_dir=join(REPO,
                                                           "checkpoint"),
                                     device=dev)
    finally:
        O._run_percal_sweep = orig
    for name in ("inception_v3", "resnet18", "vgg16"):
        s = seen[name]
        cam, prj = s["out"]
        n_png = count_pngs(setup_path, name, pcfg)
        ok_out = all(bool(torch.isfinite(t).all()) and float(t.min()) >= 0.0
                     and float(t.max()) <= 1.0 for t in (cam, prj))
        log(f"[percal] {name}: sweep {s['wall_s']:.3f} s wall for "
            f"{cam.shape[0]} images x {ITERS} iterations (CompenNet++ "
            f"and PNG writes included); steady state {s['ms_iter']:.2f} "
            f"ms/iteration; peak memory {s['peak'] / 2**30:.3f} GiB "
            f"({s['before'] / 2**30:.3f} GiB allocated before the sweep); "
            f"{n_png} PNGs; outputs finite and in [0,1]: {ok_out}; launches "
            f"{s['launches']}")
        if cam.shape[0] != 11 or prj.shape[0] != 11:
            raise AssertionError(f"unexpected PerC-AL batch {cam.shape[0]}")
        if not ok_out:
            raise AssertionError(f"{name} PerC-AL outputs are not finite in "
                                 "[0, 1]")
        if n_png != 22:
            raise AssertionError(f"expected 22 PerC-AL PNGs for {name}, "
                                 f"found {n_png}")
        if any(s["launches"].values()):
            raise AssertionError(f"the PerC-AL sweep launched the warp "
                                 f"kernel: {s['launches']}")
    return seen


class TimedCapture:
    """A simulator whose ``capture`` calls are counted and timed."""

    def __init__(self, sim):
        self.sim, self.n, self.s = sim, 0, 0.0

    def capture(self, prj_im):
        t0 = time.time()
        out = self.sim.capture(prj_im)
        self.s += time.time() - t0
        self.n += 1
        return out


def phase_onepixel(data_root, dev):
    """run_projector_based_attack for One-pixel DE at the default budget
    (block 41, 4 generations, population 50 untargeted and 10 targeted)
    through the port's SimProCams(seed=7), which made the setup: per
    classifier the captures, classifier batches, cache misses (0 or the
    phase fails), seconds split into captures and classification, success
    flags, and no warp launch; then the fixed-population check of
    :func:`onepixel_card_vs_cpu` and the digital attack as a child."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.ops import warp as W
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)

    sim = TimedCapture(SimProCams(dict(DEFAULT_SIM_SETUP_INFO), seed=7))
    cfg = O.get_attacker_cfg("One-pixel_DE", data_root, ["sim_setup"])
    seen = {}
    orig = O._run_one_pixel

    def timed(cfg_, atk, clf, *args):
        batches = []
        classify = clf.classify

        def counted(im, crop_sz=(240, 240)):
            t0 = time.time()
            out = classify(im, crop_sz)      # ends in a copy to the host
            batches.append((len(im), time.time() - t0))
            return out

        clf.classify = counted
        n0, s0, m0 = sim.n, sim.s, atk.cache_misses
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        W.reset_launch_counts()
        t0 = time.time()
        tables = orig(cfg_, atk, clf, *args)
        torch.cuda.synchronize()
        seen[clf.name] = dict(
            wall=time.time() - t0, captures=sim.n - n0, capture_s=sim.s - s0,
            batches=batches, misses=atk.cache_misses - m0, tables=tables,
            launches=dict(W.LAUNCHES), peak=torch.cuda.max_memory_allocated())
        return tables

    O._run_one_pixel = timed
    try:
        O.run_projector_based_attack(cfg, procams=sim,
                                     weights_dir=join(REPO, "checkpoint"),
                                     device=dev)
    finally:
        O._run_one_pixel = orig
    setup_path = join(data_root, "setups", "sim_setup")
    for name in ("inception_v3", "resnet18", "vgg16"):
        s = seen[name]
        gens = [b for b in s["batches"] if b[0] != 2]
        finals = [b for b in s["batches"] if b[0] == 2]
        clf_s = sum(t for _, t in s["batches"])
        flags = [bool(t["success"][0]) for t in s["tables"]]
        n_png = sum(len(os.listdir(join(setup_path, sub, "One-pixel_DE", "-",
                                        "-", name)))
                    for sub in ("prj/adv", "cam/raw/adv"))
        log(f"[onepixel] {name}: 11 attacks in {s['wall']:.3f} s wall: "
            f"{s['captures']} captures {s['capture_s']:.3f} s; "
            f"{len(gens)} classifier batches (sizes "
            f"{sorted({b for b, _ in gens})}) "
            f"{sum(t for _, t in gens):.3f} s + {len(finals)} final pairs "
            f"{sum(t for _, t in finals):.3f} s, classification {clf_s:.3f} "
            f"s; the rest {s['wall'] - s['capture_s'] - clf_s:.3f} s; cache "
            f"misses {s['misses']}; peak memory {s['peak'] / 2**30:.3f} GiB; "
            f"{n_png} PNGs; launches {s['launches']}; success (untargeted, "
            f"then 10 targeted) {flags}")
        if s["misses"]:
            raise AssertionError(f"{name}: {s['misses']} candidates missed "
                                 "the prediction cache")
        if s["captures"] > 761 or len(s["tables"]) != 11 or n_png != 22:
            raise AssertionError(f"{name}: {s['captures']} captures, "
                                 f"{len(s['tables'])} attacks, {n_png} PNGs")
        if any(s["launches"].values()):
            raise AssertionError(f"One-pixel DE launched the warp kernel: "
                                 f"{s['launches']}")
    onepixel_card_vs_cpu(data_root, dev, sim.sim)
    lines = run_child(["spaa_tpu_torch.digital_one_pixel_attack"],
                      "digital one-pixel attack (ResNet-18, sample.png)",
                      timeout=300, tag="onepixel")
    att = _grep(lines, r"^attack ([0-9.]+) s on (\S+), cache misses (\d+)")
    if not att or att[0].group(3) != "0" or \
            not att[0].group(2).startswith("cuda"):
        raise AssertionError("the digital attack did not run on the card "
                             "without cache misses")
    return seen


def onepixel_card_vs_cpu(data_root, dev, sim):
    """ResNet-18's untargeted initial population and first generation of
    trials (default budget), each captured once, classified on the card
    and on the CPU: probabilities within 1e-4, the trial-versus-parent
    decisions that differ, and whether one image scores bitwise equally
    alone, in pairs and at another position of the batch."""
    import numpy as np
    import torch
    from spaa_tpu_torch.attack.one_pixel import (BatchedDE, _bounds,
                                                 perturb_image_np)
    from spaa_tpu_torch.models.classifiers import Classifier
    from spaa_tpu_torch.train.data import load_setup_info
    from spaa_tpu_torch.utils.io import imread

    setup_path = join(data_root, "setups", "sim_setup")
    info = load_setup_info(setup_path)
    cp_sz = tuple(int(c) for c in info["classifier_crop_sz"])
    pw, ph = info["prj_im_sz"]
    im_prj = np.full((ph, pw, 3), float(info["prj_brightness"]), np.float32)
    weights = join(REPO, "checkpoint")
    card = Classifier("resnet18", weights, sort_results=False, device=dev)
    cpu = Classifier("resnet18", weights, sort_results=False, device="cpu")
    scene = imread(join(setup_path, "cam/raw/ref/img_0002.png"))[None]
    true_idx = int(card(scene, cp_sz)[1].argmax())
    cams, p_card = [], []

    def fitness(pop):
        cams.append(np.stack([sim.capture(perturb_image_np(x, im_prj, 41))
                              for x in pop]))
        p_card.append(card(cams[-1], cp_sz)[1])
        return p_card[-1][:, true_idx]

    bounds, npop = _bounds(ph, pw, 41, 1, 50)
    BatchedDE(fitness, bounds, popsize=npop, maxiter=1, seed=0).solve()
    p_cpu = [cpu(c, cp_sz)[1] for c in cams]
    err = max(float(np.abs(a - b).max()) for a, b in zip(p_card, p_cpu))
    flips = int(((p_card[1][:, true_idx] < p_card[0][:, true_idx])
                 != (p_cpu[1][:, true_idx] < p_cpu[0][:, true_idx])).sum())
    batch = cams[0].copy()
    batch[7] = batch[0]
    raws = [card(batch[:1], cp_sz)[0][0], card(batch[[0, 0]], cp_sz)[0][1],
            card(batch, cp_sz)[0][0], card(batch, cp_sz)[0][7]]
    same = [bool(torch.equal(raws[0], r)) for r in raws[1:]] \
        + [bool(torch.equal(raws[2], raws[3]))]
    log(f"[onepixel] ResNet-18 untargeted initial population ({npop}) and "
        f"its first generation, card vs CPU: max|p diff| {err:.3e} "
        f"(tolerance 1e-4); trial < parent decisions that differ: {flips} "
        f"of {npop}; one image's logits bitwise equal: alone vs in a pair, "
        f"alone vs position 0 and alone vs position 7 of a batch of "
        f"{npop}, position 0 vs 7 of that batch: {same}")
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU probabilities differ by {err}")


def run_child(args, what, timeout=900, tag="pipeline", env=None):
    """Run ``python -m <args>`` from the checkout, with ``env`` added to
    the environment; echo its output; fail on a non-zero exit. Returns
    the output lines."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": REPO,
                               **(env or {})})
    lines = (proc.stdout + proc.stderr).splitlines()
    for line in lines:
        log(f"[{tag}]   | {line[:300]}")
    log(f"[{tag}] {what}: exit code {proc.returncode} after "
        f"{time.time() - t0:.3f} s wall")
    if proc.returncode != 0:
        raise AssertionError(f"{what} failed with exit code "
                             f"{proc.returncode}")
    return lines


def _grep(lines, pattern):
    return [m for m in (re.search(pattern, line) for line in lines) if m]


def check_stats(table, n_rows):
    """Row and column counts, finite metrics (a PSNR of +inf only where its
    RMSE is 0: identical images), success rates in [0, 1]."""
    from spaa_tpu_torch.attack.summarize import COLUMNS
    if table.columns != COLUMNS or len(table) != n_rows:
        raise AssertionError(f"stats table of {len(table)} rows x "
                             f"{len(table.columns)} columns, expected "
                             f"{n_rows} x {len(COLUMNS)}")
    for c in COLUMNS[5:]:
        vals = table[c]
        if "top-1" in c or "top-5" in c:
            ok = all(0.0 <= v <= 1.0 for v in vals)
        elif c.endswith("PSNR"):
            rmse = table[c[:-4] + "RMSE"]
            ok = all(math.isfinite(v) or (v == math.inf and r == 0.0)
                     for v, r in zip(vals, rmse))
        else:
            ok = all(math.isfinite(v) for v in vals)
        if not ok:
            raise AssertionError(f"column {c} out of range: {vals}")


def resummarize_resnet18(sim_root, dev, tmp):
    """The ResNet-18 rows summarized again in this process, on the card and
    on the CPU, each on a copy of the setup whose PNGs are hard links (the
    montages exist, so none is drawn)."""
    from spaa_tpu_torch.attack.summarize import summarize_single_attacker
    skip = shutil.ignore_patterns("stats*", "pivot*")
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        root = join(tmp, f"resummarize_{name}")
        shutil.copytree(join(sim_root, "setups", "sim_setup"),
                        join(root, "setups", "sim_setup"), ignore=skip,
                        copy_function=os.link)
        t0 = time.time()
        out[name] = summarize_single_attacker(
            "SPAA", root, ["sim_setup"], classifier_names=["resnet18"],
            recreate_imgs=False, device=device)
        log(f"[pipeline] ResNet-18 rows re-summarized on {name}: "
            f"{time.time() - t0:.3f} s")
    return out


def phase_pipeline(sim_root, dev):
    """Replay, per-setup summarize and the cross-setup tables through the
    port's own entry points, then the card against the CPU."""
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.attack.summarize import COLUMNS
    from spaa_tpu_torch.utils.table import read_csv
    from spaa_tpu_torch.utils.xlsx import read_xlsx

    setups = join(sim_root, "setups")
    # summarize validates each model of the default 2000-iteration key;
    # [train] and [compennet] cut them to TRAIN_ITERS and COMPEN_ITERS, so
    # their validation images are linked under the keys summarize reads
    for attacker, sub, model in (
            ("SPAA", "cam", f"PCNet_l1+ssim_{NUM_TRAIN}_24_{TRAIN_ITERS}"),
            ("PerC-AL+CompenNet++", "prj",
             f"CompenNet++_l1+ssim_{NUM_TRAIN}_24_{COMPEN_ITERS}")):
        read_key = O.to_attacker_cfg_str(attacker)[1]
        os.symlink(model, join(setups, "sim_setup", sub, "infer", "test",
                               read_key))
        log(f"[pipeline] validation images of {model} linked as {read_key}")
    lines = run_child(["spaa_tpu_torch.main", "--data-root", sim_root,
                       "--setup-name", "sim_setup", "--steps", "6,7,8,9",
                       "--load-pretrained", "--train-iters",
                       str(COMPEN_ITERS)],
                      "main --steps 6,7,8,9 --load-pretrained")
    step_s = {int(m.group(1)): float(m.group(2))
              for m in _grep(lines, r"^\[step (\d+)\] ([0-9.]+) s")}
    step8 = _grep(lines, r"^\[step 8\] train\+attack ([0-9.]+) s, replay "
                         r"([0-9.]+) s, summarize ([0-9.]+) s")[0]
    phases = [m.group(1) for m in _grep(lines, r"^\[summarize\] (valid=.*)")]
    drain = [m.group(1) for m in _grep(lines,
                                       r"^\[summarize\] montage drain: (.*)")]
    peak = [m.group(1) for m in _grep(lines, r"^\[peak device memory\] (.*)")]
    log(f"[pipeline] replay of the 396 adversarial projections: "
        f"{step_s[6]:.3f} s; SPAA summarize of 1 setup: {step_s[7]:.3f} s "
        f"({phases[0]}; montage drain {drain[0]}); peak device memory "
        f"{peak[0]}")
    log(f"[pipeline] step 8 (PerC-AL+CompenNet++, CompenNet++ loaded): "
        f"{step_s[8]:.3f} s; load + attack of 3 classifiers "
        f"{step8.group(1)} s, replay of the 33 adversarial projections "
        f"{step8.group(2)} s, PerC-AL summarize {step8.group(3)} s "
        f"({phases[1]}; montage drain {drain[1]})")
    step9 = _grep(lines, r"^\[step 9\] attack ([0-9.]+) s, summarize "
                         r"([0-9.]+) s")[0]
    log(f"[pipeline] step 9 (One-pixel DE through the simulator, 3 "
        f"classifiers): {step_s[9]:.3f} s; attack {step9.group(1)} s, "
        f"summarize {step9.group(2)} s ({phases[2]}; montage drain "
        f"{drain[2]})")
    phase_json = join(dirname(sim_root), "phases.json")
    lines = run_child(["spaa_tpu_torch.reproduce_paper_results", "--sim",
                       "--data-root", dirname(sim_root), "--summarize-only",
                       "--keep-existing-imgs", "--phase-json", phase_json],
                      "reproduce_paper_results --summarize-only")
    rec = json.load(open(phase_json))
    phases = [m.group(1) for m in _grep(lines, r"^\[summarize\] (valid=.*)")]
    peak = [m.group(1) for m in _grep(lines, r"^\[peak device memory\] (.*)")]
    log(f"[pipeline] reproduce_paper_results --summarize-only: phases "
        f"{rec['phases']}, {rec['stats_all_rows']} rows; summarize "
        f"({'; '.join(phases)}); peak device memory {peak[0]}")

    # SPAA's grid, then PerC-AL's one config and One-pixel's, x 3
    n_rows = 36 + 3 + 3
    stats_all = read_csv(join(setups, "stats_all.txt"), sep="\t")
    check_stats(stats_all, n_rows)
    n_montages = sum(len([f for f in files if f.endswith(".png")])
                     for _, _, files in os.walk(join(setups, "sim_setup",
                                                     "ret")))
    pivot = read_xlsx(join(setups, "pivot_table_all.xlsx"))
    if rec["attackers"] != list(O.ATTACKER_NAMES):
        raise AssertionError(f"the --sim default list is {rec['attackers']}")
    attackers = [O.to_attacker_cfg_str(a)[0] for a in O.ATTACKER_NAMES]
    rows = {a: [r for r in stats_all.typed_rows() if r[1] == a]
            for a in attackers}
    # One-pixel DE has no surrogate model, so no validation bundle
    valid = {a: {c: rows[a][0][COLUMNS.index(c)] for c in COLUMNS[11:17]}
             for a in attackers[:2]}
    log(f"[pipeline] stats_all.txt {len(stats_all)} rows x "
        f"{len(stats_all.columns)} columns ({len(rows[attackers[0]])} SPAA, "
        f"{len(rows[attackers[1]])} PerC-AL, {len(rows[attackers[2]])} "
        f"One-pixel); {n_montages} montages; pivot_table_all.xlsx "
        f"{len(pivot) - 1} rows x {len(pivot[0])} columns; validation "
        f"bundles {valid}")
    if [len(rows[a]) for a in attackers] != [36, 3, 3]:
        raise AssertionError(f"stats_all rows by attacker: "
                             f"{[len(rows[a]) for a in attackers]}")
    if not all(v > 0.0 for d in valid.values() for v in d.values()):
        raise AssertionError(f"a validation bundle did not run: {valid}")
    if n_montages != 11 * n_rows or len(pivot) - 1 != n_rows:
        raise AssertionError(f"{n_montages} montages ({11 * n_rows} "
                             f"expected), {len(pivot) - 1} pivot rows "
                             f"({n_rows} expected)")

    again = resummarize_resnet18(sim_root, dev, dirname(sim_root))
    card, cpu = again["card"], again["cpu"]
    check_stats(card, 12)
    check_stats(cpu, 12)
    want = [r for r in stats_all.typed_rows() if r[4] == "resnet18"]
    metrics = COLUMNS[11:]          # validation bundle and stealth metrics
    rates = COLUMNS[5:11]
    worst, worst_text = 0.0, 0.0
    for c in metrics:
        j = COLUMNS.index(c)
        for a, b, t in zip(card[c], cpu[c], (r[j] for r in want)):
            if a == b:        # equal, infinities included
                continue
            worst = max(worst, abs(a - b))
            worst_text = max(worst_text, abs(float("%.4f" % a) - t))
    log(f"[pipeline] ResNet-18 validation and stealth columns "
        f"({len(metrics)} x 12 cells): "
        f"max |card - CPU| {worst:.3e} (tolerance 1e-4); the card's, "
        f"printed %.4f, against stats_all.txt: max {worst_text:.3e} "
        f"(tolerance 1.5e-4: one rounding step)")
    if not worst <= 1e-4:
        raise AssertionError(f"card and CPU metrics differ by {worst}")
    if not worst_text <= 1.5e-4:
        raise AssertionError(f"the card's recomputation differs from "
                             f"stats_all.txt by {worst_text}")
    differ = 0
    for k in range(12):
        a = [card[c][k] for c in rates]
        b = [cpu[c][k] for c in rates]
        differ += sum(x != y for x, y in zip(a, b))
        log(f"[pipeline] {card['Stealth_loss'][k]}/{card['d_thr'][k]} "
            f"success rates card {a} CPU {b}")
    log(f"[pipeline] success-rate cells that differ card vs CPU: {differ} of "
        f"{12 * len(rates)}")


# the root bench.py's keys (bench.py:552-569) and the port's provenance
BENCH_NUMBERS = ("pcnet_infer_fps", "pcnet_train_iters_per_s",
                 "pcnet_train_2000it_s", "pcnet_train_e2e_s",
                 "train_data_upload_s", "summarize_spaa_s_per_setup",
                 "sweep_wallclock_s", "power_limit_w")
BENCH_WORDS = ("warp_source", "clf_weights_source", "device", "attack_dtype")


def phase_bench(sim_root):
    """``python -m spaa_tpu_torch.bench`` on the trained setup at a cut
    depth: every key finite, the trained checkpoint's warp, and the warp's
    launches of its sweeps and inference chain."""
    from spaa_tpu_torch import bench as BN
    log(f"[bench] cut depth: --reps {BENCH_REPS} (of {BN.REPS}), "
        f"--train-iters {BENCH_TRAIN_ITERS} (of 2000) after a 200-iteration "
        f"warm-up; everything else at the bench's defaults")
    lines = run_child(["spaa_tpu_torch.bench", "--reps", str(BENCH_REPS),
                       "--train-iters", str(BENCH_TRAIN_ITERS)],
                      "python -m spaa_tpu_torch.bench", tag="bench",
                      env={"SPAA_BENCH_DATA_ROOT": dirname(sim_root)})
    rec = json.loads(_grep(lines, r'^(\{"metric".*)$')[-1].group(1))
    extra = rec["extra"]
    numbers = [rec["value"], rec["vs_baseline"]] + [
        extra.get(k) for k in BENCH_NUMBERS]
    if not all(isinstance(v, (int, float)) and math.isfinite(v)
               for v in numbers) or \
            not all(isinstance(extra.get(k), str) for k in BENCH_WORDS):
        raise AssertionError(f"bench line lacks a key or a finite value: "
                             f"{rec}")
    if extra["warp_source"] != "trained_ckpt" or \
            extra["train_e2e_iters"] != BENCH_TRAIN_ITERS:
        raise AssertionError(f"bench ran on {extra['warp_source']}, "
                             f"{extra['train_e2e_iters']} iterations")
    sweeps = (1 + BENCH_REPS) * len(BN.CLASSIFIERS)
    want = {"fixed_warp_fwd": sweeps * BN.ATTACK_ITERS
            + (1 + BN.INFER_REPS) * BN.INFER_CHAIN,
            "fixed_warp_bwd": sweeps * BN.ATTACK_ITERS}
    if extra["warp_launches"] != want:
        raise AssertionError(f"bench launches {extra['warp_launches']}, "
                             f"expected {want}")
    return dict(launches=extra["warp_launches"], record=rec)


def phase_bf16(sim_root, dev, f32):
    """The ResNet-18 sweep in bfloat16 on the trained setup (its earlier
    PNGs removed first), then the top-1 agreement of its camera images
    with the float32 sweep's ``f32`` under the float32 classifier."""
    import torch
    from spaa_tpu_torch.attack import orchestrate as O
    setup = join(sim_root, "setups", "sim_setup")
    cfg_str = O.to_attacker_cfg_str("SPAA")[0]
    for sub in ("prj/adv", "cam/infer/adv"):
        for d, _, _ in list(os.walk(join(setup, sub, cfg_str))):
            if os.path.basename(d) == "resnet18":
                shutil.rmtree(d)
    if count_pngs(setup, "resnet18", cfg_str):
        raise AssertionError("the float32 ResNet-18 PNGs were not removed")
    res = phase_attack(sim_root, dev, "resnet18", attack_dtype="bfloat16",
                       tag="bf16")
    clf, cp_sz = f32["clf"], tuple(int(v) for v in f32["cp_sz"])
    top1 = [clf(r["cam_best"], cp_sz)[0].argmax(1)
            for r in (f32, res)]
    agree = float((top1[0] == top1[1]).float().mean())
    log(f"[bf16] ResNet-18 sweep: bfloat16 {res['s_per_config']:.3f} "
        f"s/config ({res['ms_per_iter']:.2f} ms/iteration) vs float32 "
        f"{f32['s_per_config']:.3f} s/config ({f32['ms_per_iter']:.2f} "
        f"ms/iteration); top-1 of the {len(top1[0])} camera images under "
        f"the float32 ResNet-18 agrees for {agree:.4f} of them "
        f"(a finding, not a gate)")
    return dict(res, top1_agreement=agree)


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
        phase_conv_route(trained, dev)
        cfg = get_attacker_cfg("SPAA", data_root, ["sim_setup"])
        cfg.classifier_names = ["resnet18"]
        cfg.attack_iters = ITERS
        res = phase_main_path(cfg, trained, dev)
        check_against_cpu(data_root, res["prj_small"], res["on_card"])
        sim_root, _ = phase_sim(tmp)
        multi_root, child = start_multisetup_root(sim_root, tmp)
        try:
            train_res = phase_train(sim_root, dev)
            phase_compennet(sim_root, dev)
        except BaseException:
            child.kill()
            child.wait()
            raise
        multi = phase_multisetup(multi_root, child, sim_root, dev,
                                 train_res)
        phase_percal(sim_root, dev)
        phase_onepixel(sim_root, dev)
        sweeps = [res] + [phase_attack(sim_root, dev, name)
                          for name in ("resnet18", "vgg16", "inception_v3")]
        phase_pipeline(sim_root, dev)
        bench = phase_bench(sim_root)
        sweeps.append(phase_bf16(sim_root, dev, sweeps[1]))
    for r in rows:
        r["launches"] = sum(sw["launches"][r["name"]] for sw in sweeps) + \
            multi["waves"]["SPAA"]["launches"][r["name"]] + \
            bench["launches"][r["name"]]
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
