"""Reproduce the SPAA benchmark with the port (counterpart of the root
``reproduce_paper_results.py``, reference ``reproduce_paper_results.py``).

On every setup: train or load each attacker's model (PCNet for SPAA,
CompenNet++ for PerC-AL), run the attackers, replay their adversarial
projections through ProCams, and summarize into per-setup stats tables
and the cross-setup pivot table (paper Table 1 layout).

Runs on ``cuda`` unless ``--device cpu``. The default attacker list is the
JAX script's: SPAA and PerC-AL+CompenNet++, and with ``--sim`` One-pixel
DE, which attacks one setup at a time through that setup's own simulator.
``--multi-setup-train`` first fills both checkpoint caches, chunks of
``--multi-setup-chunk`` setups spread over the visible cards
(``parallel.multi_setup``), then forces ``--load-pretrained``;
``--multi-setup-attack`` runs the SPAA and PerC-AL sweeps in waves of one
setup per visible card (on one card, waves of one). One-pixel DE stays
one setup at a time.

Usage:
  python -m spaa_tpu_torch.reproduce_paper_results --sim
  python -m spaa_tpu_torch.reproduce_paper_results --data-root <root> \\
      --summarize-only
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from os.path import join

# the 13 benchmark object setups (reference reproduce_paper_results.py:47-61)
BENCHMARK_SETUPS = [
    "basketball", "book_jacket", "backpack", "banana", "book",
    "bucket", "coffee_mug", "lotion", "paper_towel", "pillow",
    "remote_control", "soccer_ball", "teddy",
]


class PhaseLog:
    """Wall-clock per benchmark phase, dumped as one JSON record."""

    def __init__(self, path=None):
        self.path = path
        self.phases = []
        self.t_start = time.time()

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.phases.append({"phase": name, "s": round(dt, 3)})
            print(f"[phase] {name}: {dt:.3f}s", flush=True)

    def write(self, extra=None):
        if not self.path:
            return
        rec = {"total_s": round(time.time() - self.t_start, 3),
               "phases": self.phases, **(extra or {})}
        with open(self.path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[phase] record written to {self.path}", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", default="data",
                    help="benchmark dataset root (with setups/<name>/...)")
    ap.add_argument("--setups", nargs="*", default=None,
                    help="subset of setups (default: all found)")
    ap.add_argument("--sim", action="store_true",
                    help="generate synthetic setups and run hardware-free")
    ap.add_argument("--num-sim-setups", type=int, default=1,
                    help="with --sim: number of synthetic object setups "
                         "(seeds 7 + 13k)")
    ap.add_argument("--load-pretrained", action="store_true",
                    help="load cached checkpoints instead of retraining")
    ap.add_argument("--recreate-stats-and-imgs", action="store_true")
    ap.add_argument("--keep-existing-imgs", action="store_true",
                    help="recompute stats but skip montages that already "
                         "exist")
    ap.add_argument("--summarize-only", action="store_true",
                    help="skip training and attacks; re-summarize existing "
                         "attack outputs")
    ap.add_argument("--multi-setup-train", action="store_true",
                    help="train the setups' PCNets and CompenNet++s "
                         "in chunks, a card's setups one after the other "
                         "(parallel/multi_setup.py), before the per-setup "
                         "pipeline, which then loads the cached "
                         "checkpoints")
    ap.add_argument("--multi-setup-chunk", type=int, default=None,
                    help="setups per multi-setup training call "
                         "(default: one per visible card)")
    ap.add_argument("--multi-setup-attack", action="store_true",
                    help="run the SPAA and PerC-AL sweeps in waves of one "
                         "setup per visible card "
                         "(parallel.run_spaa_attack_multi_setup and "
                         "run_percal_attack_multi_setup; the sequential "
                         "driver's outputs)")
    ap.add_argument("--phase-json", default=None,
                    help="write per-phase wall-clock + the cross-setup "
                         "pivot to this JSON file")
    ap.add_argument("--attackers", nargs="*", default=None,
                    choices=["SPAA", "PerC-AL+CompenNet++", "One-pixel_DE"],
                    help="subset of attackers (default: all applicable)")
    ap.add_argument("--weights-dir", default=None,
                    help="where the pinned classifier .pth files are "
                         "(default: <repo>/checkpoint)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    attackers = ["SPAA", "PerC-AL+CompenNet++"]
    if args.sim:
        attackers.append("One-pixel_DE")  # the simulator provides the loop
    if args.attackers:
        attackers = [a for a in attackers if a in args.attackers]
    plog = PhaseLog(args.phase_json)

    from spaa_tpu_torch.attack import (get_attacker_cfg,
                                       project_capture_real_attack,
                                       run_projector_based_attack,
                                       summarize_all_attackers)
    from spaa_tpu_torch.utils.device import resolve_device
    from spaa_tpu_torch.utils.log import print_peak_memory, print_sys_info
    from spaa_tpu_torch.utils.seed import reset_rng_seeds

    dev = resolve_device(args.device)
    print_sys_info()
    reset_rng_seeds(0)

    data_root = args.data_root
    procams = None
    sim_procams = {}
    if args.sim:
        from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                      SimProCams)
        data_root = join(args.data_root, "sim_benchmark")
        setup_list = []
        for k in range(int(args.num_sim_setups)):
            name = "sim_setup" if k == 0 else f"sim_setup_{k + 1}"
            # each synthetic object is its own ProCams world: the same
            # simulator captures the setup and replays its attacks
            sim_procams[name] = SimProCams(dict(DEFAULT_SIM_SETUP_INFO),
                                           seed=7 + 13 * k)
            if not os.path.isdir(join(data_root, "setups", name)):
                print(f"Generating synthetic setup {name} under {data_root}")
                with plog.phase(f"simgen/{name}"):
                    sim_procams[name].make_setup(data_root, name,
                                                 num_train=500, num_test=200)
            setup_list.append(name)
        procams = sim_procams[setup_list[0]]
    else:
        setups_dir = join(data_root, "setups")
        found = sorted(os.listdir(setups_dir)) if os.path.isdir(setups_dir) \
            else []
        setup_list = args.setups or [s for s in BENCHMARK_SETUPS
                                     if s in found] or found
        if not setup_list:
            raise SystemExit(
                f"No setups under {setups_dir}. Unpack the SPAA benchmark "
                "dataset there, or run with --sim for a synthetic benchmark.")

    if args.multi_setup_train and len(setup_list) > 1:
        from spaa_tpu_torch.parallel import (
            pretrain_compennets_pp_multi_setup, pretrain_pcnets_multi_setup)
        from spaa_tpu_torch.train.train import get_model_train_cfg
        for model_name, fill in (
                ("PCNet", pretrain_pcnets_multi_setup),
                ("CompenNet++", pretrain_compennets_pp_multi_setup)):
            mc = get_model_train_cfg(None, data_root, setup_list)
            mc.model_list = [model_name]
            with plog.phase(f"multi_setup_train/{model_name}"):
                fill(mc, chunk=args.multi_setup_chunk, device=dev)
        # the per-setup pipelines now find every checkpoint
        args.load_pretrained = True

    def _procams_for(s):
        return sim_procams.get(s, procams)

    for attacker_name in [] if args.summarize_only else attackers:
        if attacker_name == "One-pixel_DE":
            for s in setup_list:   # one setup at a time (hardware loop)
                c1 = get_attacker_cfg(attacker_name, data_root, [s])
                with plog.phase(f"attack/One-pixel_DE/{s}"):
                    run_projector_based_attack(
                        c1, procams=_procams_for(s),
                        weights_dir=args.weights_dir, device=dev)
            continue
        cfg = get_attacker_cfg(attacker_name, data_root, setup_list,
                               load_pretrained=args.load_pretrained)
        if args.multi_setup_attack and len(setup_list) > 1:
            from spaa_tpu_torch.parallel import (
                run_percal_attack_multi_setup, run_spaa_attack_multi_setup)
            wave = run_spaa_attack_multi_setup if attacker_name == "SPAA" \
                else run_percal_attack_multi_setup
            with plog.phase(f"attack_wave/{attacker_name}"):
                wave(cfg, weights_dir=args.weights_dir, device=dev)
        else:
            with plog.phase(f"attack/{attacker_name}"):
                run_projector_based_attack(cfg, weights_dir=args.weights_dir,
                                           device=dev)
        if procams is not None:
            with plog.phase(f"replay/{attacker_name}"):
                for s in setup_list:
                    c1 = get_attacker_cfg(attacker_name, data_root, [s])
                    project_capture_real_attack(c1, _procams_for(s))

    with plog.phase("summarize_all"):
        table, pivot = summarize_all_attackers(
            attackers, data_root, setup_list, recreate_stats_and_imgs=True,
            weights_dir=args.weights_dir,
            recreate_imgs=not args.keep_existing_imgs, device=dev)
    print(table)
    print(pivot)
    plog.write({"n_setups": len(setup_list), "setups": setup_list,
                "attackers": attackers, "device": str(dev),
                "multi_setup_train": bool(args.multi_setup_train),
                "multi_setup_attack": bool(args.multi_setup_attack),
                "summarize_only": bool(args.summarize_only),
                "stats_all_rows": len(table),
                "pivot": [dict(zip(pivot.columns, r))
                          for r in pivot.typed_rows()]})
    print_peak_memory(dev)
    print("\nAll done! Stats under", join(data_root, "setups"))


if __name__ == "__main__":
    main()
