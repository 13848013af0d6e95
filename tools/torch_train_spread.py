#!/usr/bin/env python3
"""Run-to-run spread of PCNet training on one GPU.

    python3 tools/torch_train_spread.py [--runs 2] [--deterministic-runs 2]
        [--iters 2000] [--valid-rate 100] [--seeds 123 ...]
        [--draws spaa_tpu torch] [--dtype float32|float64] [--json PATH]

Generates the benchmark-size sim setup with the port's ``SimProCams``
(seed 7, 500 training and 200 validation pairs) in a temporary data root,
then, for each seed, trains PCNet as ``train_eval_pcnet`` does (its seeded
init and minibatch plan, batch 24), ``--runs`` times with PyTorch's
default CUDA kernels and ``--deterministic-runs`` times under
``torch.use_deterministic_algorithms(True)``. ``--draws`` picks the
initial weights, each in turn: ``spaa_tpu`` is ``PCNet.init_weights``
(the reference package's own draw for the seed); ``torch`` re-creates the
draw the port used before it, the same distributions drawn from a
``torch.Generator`` seeded with the seed. ``--dtype float64`` trains in
float64, where rounding no longer steers the run. The seed always draws
the minibatch plan.

Prints, for every run, every ``--valid-rate`` iterations: the validation
PSNR, the last minibatch's loss, the affine matrix, the share of the
sampling grid clamped at the border, the share of output values at 0,
and how much the output varies with the projector image (the mean over
pixels of the standard deviation across 10 validation images, over the
same for the captures). Then the ms per training iteration (validation
excluded) and whether the runs of one seed and mode end with bitwise-equal
weights; ``--json`` writes the same as one object.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from os.path import abspath, dirname, join

# deterministic cuBLAS needs its workspace fixed before it starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, dirname(dirname(abspath(__file__))))


class Curve:
    """The ``curve_logger`` of ``train_model``, kept in memory."""

    def __init__(self):
        self.rows = []

    def append(self, step, **values):
        self.rows.append(dict(step=step, **values))


def probe(model, x, y, scene, mask):
    """Where a run stands besides its metrics (see the module docstring)."""
    import torch
    with torch.no_grad():
        grid = model.warping_net.fine_grid()
        out = model(x, scene, mask)
        return dict(
            affine=[round(v, 4) for v in
                    model.warping_net.affine_mat.flatten().tolist()],
            grid_clamped=float((grid.abs() >= 1.0).float().mean()),
            out_zero=float((out == 0).float().mean()),
            x_dependence=float(out.std(0).mean() / y.std(0).mean()))


def torch_draw(model, seed):
    """The port's PCNet init before it drew ``spaa_tpu``'s weights:
    He-normal convolutions (the grid refiner's N(0, 1e-4)), uniform
    transposed convolutions and biases, drawn in module order from a
    ``torch.Generator`` seeded with ``seed``."""
    import torch
    from torch import nn
    gen = torch.Generator().manual_seed(seed)
    refine = {id(m) for m in model.warping_net.grid_refine_net.modules()} \
        if model.warping_net.with_refine else set()

    def uniform(t, bound):
        t.copy_((torch.rand(t.shape, generator=gen, dtype=t.dtype) * 2 - 1)
                * bound)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):
                cin, cout, kh, kw = m.weight.shape
                uniform(m.weight, (kh * kw * cin) ** -0.5)
                uniform(m.bias, (kh * kw * cout) ** -0.5)
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = 1e-4 if id(m) in refine else (2.0 / fan_in) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * std)
                uniform(m.bias, fan_in ** -0.5)
    return model


def train_once(data, cfg, dev, dtype, seed, deterministic, draw, tag):
    """One training run: (curve with probes, final weights on the host,
    ms per training iteration)."""
    import torch
    from spaa_tpu_torch.train import pipeline as P
    from spaa_tpu_torch.train.data import as_uint8_wire
    from spaa_tpu_torch.train.train import (make_evaluator,
                                            make_pcnet_optimizer,
                                            sample_batch_indices, train_model)
    from spaa_tpu_torch.utils.seed import reset_rng_seeds

    torch.use_deterministic_algorithms(deterministic)
    torch.backends.cudnn.deterministic = deterministic
    scene = torch.from_numpy(data["cam_scene"]).to(dev, dtype)
    mask = torch.from_numpy(data["mask"]).to(dev, dtype)
    n = cfg.num_train
    key = reset_rng_seeds(seed)
    if draw == "torch":
        model = P._set_affine(torch_draw(P._new_pcnet(
            "PCNet", data["cam_scene"].shape[1:3]), seed),
            data["mask_corners"])
    else:
        model = P._build_pcnet("PCNet", data["cam_scene"].shape[1:3],
                               data["mask_corners"], key)
    model = model.to(dev, dtype)
    prj_v = as_uint8_wire(data["prj_valid"])
    cam_v = as_uint8_wire(data["cam_valid"])
    evaluate = make_evaluator(
        lambda x: model(x.to(dtype), scene, mask).float(), prj_v, cam_v, dev)
    px = torch.from_numpy(prj_v[:10]).to(dev, dtype) / 255.0
    py = torch.from_numpy(cam_v[:10]).to(dev, dtype) / 255.0
    valid_s = [0.0]
    probes = []

    def timed_valid():
        torch.cuda.synchronize()
        t = time.time()
        out = evaluate()
        probes.append(probe(model, px, py, scene, mask))
        torch.cuda.synchronize()
        valid_s[0] += time.time() - t
        return out

    opt, sched = make_pcnet_optimizer(model, cfg)
    idx = sample_batch_indices(n, cfg.batch_size, cfg.max_iters)
    curve = Curve()
    torch.cuda.synchronize()
    t0 = time.time()
    train_model(P.make_pcnet_loss(model, scene, mask), model, opt, sched,
                dict(inputs=as_uint8_wire(data["prj_train"][:n]),
                     targets=as_uint8_wire(data["cam_train"][:n])),
                idx, cfg, dev, valid_fn=timed_valid, log_prefix=f"[{tag}] ",
                curve_logger=curve)
    torch.cuda.synchronize()
    ms_iter = 1e3 * (time.time() - t0 - valid_s[0]) / cfg.max_iters
    for row, p in zip(curve.rows, probes):
        row.update(p)
        print(f"[{tag}] step {row['step']}: PSNR {row['valid_psnr']:.4f} "
              f"loss {row['train_loss']:.5f} affine {p['affine']} grid "
              f"clamped {p['grid_clamped']:.4f} output at 0 "
              f"{p['out_zero']:.4f} x-dependence {p['x_dependence']:.4f}",
              flush=True)
    weights = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    return curve.rows, weights, ms_iter


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--deterministic-runs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--valid-rate", type=int, default=100)
    ap.add_argument("--seeds", type=int, nargs="+", default=[123])
    ap.add_argument("--draws", nargs="+", default=["spaa_tpu"],
                    choices=["spaa_tpu", "torch"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_spread: no CUDA device")
    from spaa_tpu_torch.train.data import load_data
    from spaa_tpu_torch.train.train import get_model_train_cfg
    from spaa_tpu_torch.utils.device import resolve_device
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dtype = getattr(torch, args.dtype)
    print(f"[spread] {smi} | torch {torch.__version__} | {args.dtype}",
          flush=True)

    with tempfile.TemporaryDirectory(prefix="train_spread_") as tmp:
        root = join(tmp, "data")
        SimProCams(dict(DEFAULT_SIM_SETUP_INFO), seed=7).make_setup(
            root, "sim_setup", num_train=500, num_test=200)
        data = load_data(root, "sim_setup")
    cfg = get_model_train_cfg(["PCNet"], root, ["sim_setup"], single=True)
    cfg.num_train = min(cfg.num_train, data["prj_train"].shape[0])
    cfg.max_iters = args.iters
    cfg.valid_rate = args.valid_rate

    result = dict(device=smi, iters=args.iters, dtype=args.dtype, runs=[])
    finals = {}
    modes = [False] * args.runs + [True] * args.deterministic_runs
    for draw, seed in ((d, s) for d in args.draws for s in args.seeds):
        for k, det in enumerate(modes):
            mode = "deterministic" if det else "default"
            tag = f"{draw} draw seed {seed} run {k} {mode}"
            try:
                rows, weights, ms_iter = train_once(data, cfg, dev, dtype,
                                                    seed, det, draw, tag)
            except RuntimeError as e:      # an op without a deterministic form
                print(f"[spread] {tag}: failed: {e}", flush=True)
                result["runs"].append(dict(draw=draw, seed=seed, mode=mode,
                                           error=str(e)))
                continue
            first = finals.setdefault((draw, seed, mode), weights)
            same = all(torch.equal(first[n], w) for n, w in weights.items())
            diff = max(float((first[n] - w).abs().max())
                       for n, w in weights.items())
            last = rows[-1]
            print(f"[spread] {tag}: {ms_iter:.2f} ms/iteration; final valid "
                  f"PSNR {last['valid_psnr']:.4f} RMSE "
                  f"{last['valid_rmse']:.4f} SSIM {last['valid_ssim']:.4f}; "
                  f"weights equal to the first such run: {same} (max|diff| "
                  f"{diff:.3e})", flush=True)
            result["runs"].append(dict(draw=draw, seed=seed, mode=mode,
                                       ms_per_iter=ms_iter, curve=rows,
                                       same_as_first=same,
                                       max_abs_weight_diff=diff))
    torch.use_deterministic_algorithms(False)
    if args.json:
        os.makedirs(dirname(abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(dict(device=smi, dtype=args.dtype, runs=[
        {k: v for k, v in r.items() if k != "curve"}
        | ({"final_psnr": r["curve"][-1]["valid_psnr"]} if "curve" in r
           else {}) for r in result["runs"]])))


if __name__ == "__main__":
    main()
