#!/usr/bin/env python3
"""Rebuild the trained PCNet checkpoint that the port's bench prefers
(counterpart of ``tools/make_bench_ckpt.py``).

    python3 tools/torch_make_bench_ckpt.py [root] [--device cpu]

``spaa_tpu_torch.bench`` looks for ``<root>/checkpoint/
*_PCNet_l1+ssim_*.flax`` and ``<root>/sim_benchmark/setups/sim_setup``
(``root``: ``$SPAA_BENCH_DATA_ROOT``, else ``simbench`` in the system's
temporary directory, the default here too). This writes the setup with
``SimProCams(seed=7)`` (500 + 200 pairs) if it is missing, then runs
``train_eval_pcnet`` with ``load_pretrained`` (training only when no
checkpoint of the run's key exists: 2000 iterations at batch 24), and
checks that a PCNet checkpoint is there. No attack, no summarize. Runs on
the card unless ``--device cpu``.
"""

import argparse
import os
import sys
from os.path import abspath, dirname, isdir, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))


def main(argv=None):
    from spaa_tpu_torch.bench import default_root
    from spaa_tpu_torch.train.pipeline import train_eval_pcnet
    from spaa_tpu_torch.train.train import get_model_train_cfg
    from spaa_tpu_torch.utils.device import resolve_device
    from spaa_tpu_torch.utils.seed import reset_rng_seeds
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=None,
                    help="artifact root (default: $SPAA_BENCH_DATA_ROOT, "
                         "else <tmp>/simbench)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    root = args.root or os.environ.get("SPAA_BENCH_DATA_ROOT") \
        or default_root()
    dev = resolve_device(args.device)
    data_root = join(root, "sim_benchmark")

    reset_rng_seeds(0)
    sim = SimProCams(dict(DEFAULT_SIM_SETUP_INFO), seed=7)  # --sim setup 0
    if not isdir(join(data_root, "setups", "sim_setup")):
        print(f"Generating synthetic setup sim_setup under {data_root}")
        sim.make_setup(data_root, "sim_setup", num_train=500, num_test=200)

    cfg = get_model_train_cfg(["PCNet"], data_root, ["sim_setup"],
                              load_pretrained=True)  # reuse if present
    _, table, _ = train_eval_pcnet(cfg, dev)
    print(table.to_string())
    ckpt_dir = join(root, "checkpoint")
    ckpts = sorted(f for f in (os.listdir(ckpt_dir) if isdir(ckpt_dir)
                               else [])
                   if "_PCNet_" in f and f.endswith(".flax"))
    if not ckpts:
        raise SystemExit(f"no PCNet checkpoint written under {ckpt_dir}")
    print(f"checkpoint ready: {join(ckpt_dir, ckpts[-1])}")


if __name__ == "__main__":
    main()
