#!/usr/bin/env python3
"""Where the time of the port's multi-setup training goes on one GPU: the
port's program (``train_pcnet_multi_setup``: each setup ``train_model``'s
module step, one setup after the other) against the design it replaced,
the setups stacked into one step under ``torch.func.vmap`` (the
counterpart of ``spaa_tpu``'s ``jax.vmap``; kept here only as the
comparison).

    python3 tools/torch_profile_multi_setup.py [--setups 2] [--iters 10]

Full width (camera 240x320, projector 256x256), batch 24 a setup, float32,
PCNet from ``spaa_tpu``'s initial draw with the committed fixture's mask
corners, random uint8 training pairs (the timing depends on the shapes
only), PyTorch's default kernels, iterations <= 400 (l1 loss). Prints,
for one setup and for ``--setups`` setups through the port and stacked:

- ms per iteration (host clock around runs of 3 and 3 + ``--iters``
  iterations, differenced);
- a ``torch.profiler`` trace of a run of ``--iters`` iterations: device
  time by kernel (top 15, per iteration), the summed kernel time and the
  device's busy time (the union of the kernels' intervals).
"""

import argparse
import sys
import time
from os.path import abspath, dirname, join

REPO = dirname(dirname(abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--setups", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.func import functional_call, stack_module_state, vmap
    from torch.profiler import ProfilerActivity, profile

    from spaa_tpu_torch.models.pcnet import PCNet
    from spaa_tpu_torch.parallel import train_pcnet_multi_setup
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.train.data import nayar_separation
    from spaa_tpu_torch.train.train import (compute_loss,
                                            get_model_train_cfg,
                                            make_pcnet_optimizer)
    from spaa_tpu_torch.utils.device import resolve_device
    from spaa_tpu_torch.utils.imgproc_host import threshold_im
    from spaa_tpu_torch.utils.io import imread_dir
    from spaa_tpu_torch.utils.seed import reset_rng_seeds

    dev = resolve_device("cuda")
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    setup = join(REPO, "spaa_tpu_torch", "assets", "sim_setup")
    direct, _ = nayar_separation(imread_dir(join(setup, "cam/raw/cb")))
    mask, _, corners = threshold_im(direct)
    scene = imread_dir(join(setup, "cam/raw/ref"))[1:2]
    cam_hw = scene.shape[1:3]
    rng = np.random.default_rng(0)
    n_pairs = 100
    prj = rng.integers(0, 256, (n_pairs, 256, 256, 3), np.uint8)
    cam = rng.integers(0, 256, (n_pairs, *cam_hw, 3), np.uint8)
    cfg = get_model_train_cfg(["PCNet"], None, None)

    def draws(s):
        return [P._build_pcnet("PCNet", cam_hw, corners,
                               reset_rng_seeds(123)).to(dev)
                for _ in range(s)]

    def run_port(s, iters):
        idx = rng.integers(0, n_pairs, (iters, 24))
        return train_pcnet_multi_setup(
            PCNet(out_size=tuple(cam_hw)),
            [m.state_dict() for m in draws(s)],
            lambda m: make_pcnet_optimizer(m, cfg),
            np.stack([scene] * s),
            np.stack([mask.astype(np.float32)[..., None]] * s),
            np.stack([prj] * s), np.stack([cam] * s), idx)

    class Stacked:
        """The ``[S, ...]`` parameters under the module's names, which
        ``make_pcnet_optimizer`` groups by."""

        def __init__(self, params):
            self.params = params

        def named_parameters(self):
            return iter(self.params.items())

    def run_stacked(s, iters):
        # one step for the s setups: vmap of functional_call over the
        # stacked parameters, one backward, one Adam over [S, ...] tensors
        # (Adam and its L2 are elementwise: S independent Adams)
        net = PCNet(out_size=tuple(cam_hw)).to(dev)
        params, _ = stack_module_state(draws(s))
        opt, sched = make_pcnet_optimizer(Stacked(params), cfg)
        sc = torch.from_numpy(np.stack([scene] * s)).to(dev)
        mk = torch.from_numpy(np.stack([mask.astype(np.float32)[..., None]]
                                       * s)).to(dev)
        x_all = torch.from_numpy(np.stack([prj] * s)).to(dev)
        y_all = torch.from_numpy(np.stack([cam] * s)).to(dev)

        def one(p, x, y, sc1, mk1):
            return compute_loss(functional_call(net, p, (x, sc1, mk1)), y,
                                "l1+ssim", ssim_weight=0.0)

        for j in range(iters):
            idx = torch.from_numpy(rng.integers(0, n_pairs, 24)).to(dev)
            x = x_all.index_select(1, idx).float() / 255.0
            y = y_all.index_select(1, idx).float() / 255.0
            losses, _ = vmap(one)(params, x, y, sc, mk)
            opt.zero_grad(set_to_none=True)
            losses.sum().backward()
            opt.step()
            sched.step()
        return losses.detach().cpu()

    runs = [("port", 1, run_port), ("port", args.setups, run_port),
            ("stacked", args.setups, run_stacked)]
    for what, s, run in runs:
        run(s, 3)                                  # warm-up
        walls = []
        for iters in (3, 3 + args.iters):
            torch.cuda.synchronize()
            t0 = time.time()
            run(s, iters)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        ms = 1e3 * (walls[1] - walls[0]) / args.iters
        print(f"{what}, S = {s}: {ms:.2f} ms per iteration ({ms / s:.2f} a "
              f"setup)", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.time()
            run(s, args.iters)
            torch.cuda.synchronize()
            wall = time.time() - t0
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events)
        busy, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        kernels = [r for r in prof.key_averages()
                   if r.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(r.device_time_total for r in kernels)
        print(f"{what}, S = {s}: profiled run of {args.iters} iterations {wall:.3f}"
              f" s wall (set-up included); kernel time {total / 1e3:.1f} ms,"
              f" device busy {busy / 1e3:.1f} ms", flush=True)
        for e in sorted(kernels, key=lambda r: -r.device_time_total)[:15]:
            print(f"  {e.device_time_total / 1e3 / args.iters:9.3f} "
                  f"ms/iter  x{e.count // args.iters:4d}  {e.key[:110]}",
                  flush=True)


if __name__ == "__main__":
    main()
