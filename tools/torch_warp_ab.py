#!/usr/bin/env python3
"""Time the port's fixed-grid warp kernel against an older version of it,
in one process on one card.

    python3 tools/torch_warp_ab.py --old OLD.cu [--json OUT.json]

``OLD.cu``: a CUDA source with the first port's C entry point
``fixed_warp_gather`` (a CSR gather with strides, e.g. ``git show
f3dea3e:spaa_tpu_torch/csrc/fixed_warp.cu``), built with the same ``nvcc``
flags as ``spaa_tpu_torch/ops/_build.py``. Shapes are the main path's (the
committed checkpoint's baked grid with the fixture's mask folded in, as
``chip_smoke.py`` builds it; B = 132 NHWC 256x256x3 images, 240x320
output). Each pass is checked against the plain version, then timed in
the order old, new, new, old: CUDA events around 50 back-to-back launches
divided by 50, the median of 7 such runs.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from os.path import abspath, dirname, join

REPO = dirname(dirname(abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def build_old(src, lib):
    """nvcc ``src`` into ``lib`` with ops/_build.py's flags and bind the
    first port's entry point."""
    from spaa_tpu_torch.ops import _build
    cmd = _build._command("fixed_warp", lib)
    done = subprocess.run(cmd[:-1] + [src], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}"
                           f"{done.stderr}")
    old = ctypes.CDLL(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old.fixed_warp_gather.argtypes = [p, p, p, p, p, i, i, i,
                                      ll, ll, ll, ll, ll, ll, p]
    old.fixed_warp_gather.restype = ctypes.c_int
    return old


def old_pass(lib, warp, x, backward):
    """The first port's CSR gather on this warp's CSR tables."""
    import torch
    n, c = x.shape[0], (x.shape[1] if backward else x.shape[3])
    (h, w), (ho, wo) = warp.src_hw, warp.out_hw
    hwc, chw = h * w * c, c * ho * wo
    if backward:
        t, out = warp.bwd, torch.empty((n, h, w, c), device=x.device)
        strides = (chw, 1, ho * wo, hwc, c, 1)
    else:
        t, out = warp.fwd, torch.empty((n, c, ho, wo), device=x.device)
        strides = (hwc, c, 1, chw, 1, ho * wo)
    rc = lib.fixed_warp_gather(
        x.data_ptr(), out.data_ptr(), t.row_ptr.data_ptr(), t.col.data_ptr(),
        t.w.data_ptr(), t.rows, n, c, *strides,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old kernel launch failed: CUDA error {rc}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="older fixed_warp.cu to compare with")
    ap.add_argument("--json", help="write the results here as JSON")
    args = ap.parse_args()
    import torch
    from spaa_tpu_torch.attack.orchestrate import pcnet_warp
    from spaa_tpu_torch.ops import _build
    from spaa_tpu_torch.ops import warp as W
    from spaa_tpu_torch.train.pipeline import load_pretrained_pcnet
    from spaa_tpu_torch.train.train import get_model_train_cfg

    dev, smi = chip_smoke.phase_device()
    _build.build_all()
    with tempfile.TemporaryDirectory(prefix="warp_ab_") as tmp:
        data_root = chip_smoke.make_data_root(tmp)
        mc = get_model_train_cfg(["PCNet"], data_root, ["sim_setup"])
        trained, _ = load_pretrained_pcnet(mc, "sim_setup", device=dev)
        warp = pcnet_warp(trained, trained.simplify())
        old = build_old(abspath(args.old), join(tmp, "old.so"))

    hp, wp = warp.src_hw
    ho, wo = warp.out_hw
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((132, hp, wp, 3), generator=gen, device=dev)
    dout = torch.randn((132, 3, ho, wo), generator=gen, device=dev)
    res = dict(device=smi, times_ms={}, max_abs_err={})
    with torch.no_grad():
        for k, xi, new, plain in (
                ("fwd", x, W.warp_forward, W.warp_forward_plain),
                ("bwd", dout, W.warp_backward, W.warp_backward_plain)):
            ref = plain(warp, xi)
            fns = {"old": lambda: old_pass(old, warp, xi, k == "bwd"),
                   "new": lambda: new(warp, xi)}
            for label in ("old", "new", "new", "old"):
                err = float((fns[label]() - ref).abs().max())
                if not err <= 1e-5:
                    raise AssertionError(f"{k} {label}: max|diff| {err} "
                                         "vs plain")
                med, lo, hi = chip_smoke.cuda_ms(fns[label])
                key = f"{k} {label}"
                res["times_ms"].setdefault(key, []).append(med)
                res["max_abs_err"][key] = err
                chip_smoke.log(f"[ab] {key}: {med:.4f} ms (min {lo:.4f}, "
                               f"max {hi:.4f}) max|diff|={err:.3e}")
    if args.json:
        os.makedirs(dirname(abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
