#!/usr/bin/env python3
"""Where the time of the PyTorch port's SPAA iteration goes, on one GPU.

    python3 tools/torch_profile_sweep.py [--iters 3]

Builds the full-width main path of chip_smoke.py (committed sim-setup
fixture and PCNet checkpoint, ResNet-18, 12 configs x 11 = 132 images,
float32) and reports, after two warm-up iterations:

- the iteration time (host clock around ``--iters`` iterations that
  end in a synchronize);
- each layer of the iteration timed alone with CUDA events (median of 5):
  PCNet forward with its graph, PCNet pullback, classifier forward + VJP,
  colour losses (caml2 on 132 images, CIEDE2000 on the 88 camdE ones)
  + VJP; the rest of the iteration is masks, selection and the update;
- a ``torch.profiler`` trace of ``--iters`` iterations: device time by
  kernel (top 25) and the device's busy and idle share of the wall-clock
  (busy = the union of the kernels' time intervals).

``--cudnn-benchmark`` lets cuDNN time its algorithms per convolution shape
(``torch.backends.cudnn.benchmark = True``) instead of picking them by
heuristic, for comparing the two in one call.

``--infer`` profiles the frozen PCNet's forward alone, without a graph, as
``python -m spaa_tpu_torch.bench`` times it for ``pcnet_infer_fps``
(11 images) and at the sweep's 132: ms per forward (CUDA events, median
of 5) with cuDNN's heuristic and then with benchmark mode, and the top
kernels of 5 forwards at 11 images under each.
"""

import argparse
import statistics
import sys
import tempfile
import time
from os.path import abspath, dirname, join

REPO = dirname(dirname(abspath(__file__)))
sys.path.insert(0, REPO)


def cuda_ms(fn, reps=5):
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cudnn-benchmark", action="store_true")
    ap.add_argument("--infer", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S
    from spaa_tpu_torch.attack import orchestrate as O
    from spaa_tpu_torch.attack.spaa import (_per_sample_l2, _spaa_body,
                                            spaa_attack_batched)
    from spaa_tpu_torch.models.classifiers import Classifier
    from spaa_tpu_torch.ops.color import ciede2000_diff, rgb2lab_diff
    from spaa_tpu_torch.train.pipeline import load_pretrained_pcnet
    from spaa_tpu_torch.train.train import get_model_train_cfg
    from spaa_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = resolve_device("cuda")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    print(f"[profile] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cudnn.benchmark={args.cudnn_benchmark}")
    with tempfile.TemporaryDirectory(prefix="profile_sweep_") as tmp:
        data_root = S.make_data_root(tmp)
        mc = get_model_train_cfg(["PCNet"], data_root, ["sim_setup"])
        trained, _ = load_pretrained_pcnet(mc, "sim_setup", device=dev)
    cfg = O.get_attacker_cfg("SPAA", data_root, ["sim_setup"])
    info = trained.setup_info
    cp_sz = tuple(int(v) for v in info["classifier_crop_sz"])
    clf = Classifier("resnet18", join(REPO, "checkpoint"), device=dev)
    pcnet_apply = O.make_pcnet_fn(trained)
    if args.infer:
        return profile_infer(pcnet_apply, dev)
    logits_fn = O.make_attack_logits_fn(clf, cp_sz)
    (_, _, prj_init, tgt, targeted, w, dt,
     scfg) = O.build_spaa_sweep_arrays(cfg, info, list(range(10)), 500)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a).to(dev, dtype)

    prj0, tgt_t, tg_t, w_t, dt_t = (t(prj_init), t(tgt, torch.long),
                                    t(targeted, torch.bool), t(w), t(dt))
    scene = trained.cam_scene
    b = prj0.shape[0]
    spaa_attack_batched(pcnet_apply, logits_fn, scene, prj0, tgt_t, tg_t,
                        w_t, dt_t, scfg._replace(iters=2))
    state = (prj0, prj0, scene.expand(b, -1, -1, -1).contiguous(),
             torch.full((b,), 1e6, device=dev))

    def step():
        return _spaa_body(pcnet_apply, logits_fn, scene, state, prj0, tgt_t,
                          tg_t, w_t, dt_t, scfg)

    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(args.iters):
        step()
    torch.cuda.synchronize()
    it_ms = 1e3 * (time.time() - t0) / args.iters
    print(f"[profile] iteration: {it_ms:.2f} ms (host clock, "
          f"{args.iters} iterations, B={b})")

    # each layer alone
    prj = prj0.clone().requires_grad_(True)
    cam = pcnet_apply(prj)
    cot = torch.randn_like(cam)
    c = cam.detach().requires_grad_(True)
    lo, hi = scfg.camde_range
    raw_cot = torch.zeros((b, 1000), device=dev)
    raw_cot[torch.arange(b), tgt_t] = 1.0 / b
    scene_b = scene.expand(b, -1, -1, -1)
    scene_lab = rgb2lab_diff(scene)

    def colour():
        caml2 = _per_sample_l2(scene_b - c)
        de = ciede2000_diff(rgb2lab_diff(c[lo:hi]),
                            scene_lab.expand(hi - lo, -1, -1, -1))
        loss = caml2.mean() + de.mean()
        return torch.autograd.grad(loss, c)

    layers = {
        "pcnet_forward": cuda_ms(lambda: pcnet_apply(prj)),
        "pcnet_pullback": cuda_ms(lambda: torch.autograd.grad(
            cam, prj, cot, retain_graph=True)),
        "classifier_fwd_vjp": cuda_ms(lambda: torch.autograd.grad(
            logits_fn(c), c, raw_cot)),
        "colour_fwd_vjp": cuda_ms(colour),
    }
    rest = it_ms - sum(layers.values())
    for k, v in layers.items():
        print(f"[profile] layer {k}: {v:.2f} ms ({100 * v / it_ms:.1f}%)")
    print(f"[profile] layer rest (masks, selection, update, host): "
          f"{rest:.2f} ms ({100 * rest / it_ms:.1f}%)")

    # kernel view
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.time()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for a, z in spans:          # union of kernel intervals, in us
        if z > end:
            busy += z - max(a, end)
            end = z
    dev_total = sum(e.self_device_time_total for e in kernels)
    if busy <= 0:
        print("[profile] the profiler recorded no device time")
        return
    print(f"[profile] device busy {busy / 1e3 / args.iters:.2f} ms per "
          f"iteration of {wall_us / 1e3 / args.iters:.2f} ms wall: idle "
          f"share {100 * (1 - busy / wall_us):.1f}% (kernel time summed "
          f"over streams: {dev_total / 1e3 / args.iters:.2f} ms)")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:25]:
        print(f"[profile] {e.self_device_time_total / 1e3 / args.iters:9.3f} "
              f"ms/iter {100 * e.self_device_time_total / dev_total:5.1f}% "
              f"x{e.count // args.iters:<4d} {e.key[:110]}")


def top_kernels(prof, n_calls, what, top=12):
    """Print the profiler's device time by kernel, per call of the
    profiled function."""
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        print(f"[profile] {what}: the profiler recorded no device time")
        return
    print(f"[profile] {what}: kernel time {total / 1e3 / n_calls:.3f} ms "
          f"per forward")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n_calls:9.3f} "
              f"ms {100 * e.self_device_time_total / total:5.1f}% "
              f"x{e.count // n_calls:<4d} {e.key[:110]}")


def profile_infer(pcnet_apply, dev, batches=(11, 132), n=5):
    """The frozen PCNet forward without a graph: ms per forward at each
    batch, first on cuDNN's heuristic, then in benchmark mode, and the
    top kernels of ``n`` forwards at the first batch under each."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    prj = {b: torch.from_numpy(np.random.default_rng(2).random(
        (b, 256, 256, 3), np.float32)).to(dev) for b in batches}
    with torch.no_grad():
        for mode in (False, True):
            torch.backends.cudnn.benchmark = mode
            for b in batches:
                ms = cuda_ms(lambda: pcnet_apply(prj[b]))
                print(f"[profile] infer cudnn.benchmark={mode} B={b}: "
                      f"{ms:.3f} ms a forward, {1e3 * b / ms:.1f} images/s")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    pcnet_apply(prj[batches[0]])
                torch.cuda.synchronize()
            top_kernels(prof, n, f"infer cudnn.benchmark={mode} "
                                 f"B={batches[0]}")


if __name__ == "__main__":
    main()
