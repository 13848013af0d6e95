#!/usr/bin/env python3
"""bfloat16 against float32 SPAA sweeps of the port on a trained sim
setup, compared at the level of decisions (counterpart of
``tools/bf16_equiv_check.py``).

    python3 tools/torch_bf16_equiv_check.py [--data-root ROOT] [--setup NAME]

The port computes in float32 by default; ``attack_dtype`` bfloat16 is an
opt-in for the shading CNN and the classifiers (the warp stays float32).
This runs the full 12-config SPAA sweep of the three classifiers twice,
``attack_dtype`` bfloat16 then float32, each after ``reset_rng_seeds(0)``,
against the setup's cached PCNet checkpoint, replays both through the
port's ``SimProCams``, summarizes both, and compares the six success-rate
columns row for row (rows sorted by stealth loss, d_thr, classifier).

Needs a trained sim setup under ``<ROOT>/sim_benchmark/setups/<NAME>``
(``python -m spaa_tpu_torch.bench`` or ``tools/torch_make_bench_ckpt.py``
leaves one; ``ROOT`` defaults to ``$SPAA_BENCH_DATA_ROOT``, else
``simbench`` in the system's temporary directory). Exit codes: 2 without
the setup, 0 when every success cell matches, 1 when one differs. Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from os.path import abspath, dirname, isdir, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))

SUCCESS_COLS = ["T.top-1_infer", "T.top-5_infer", "T.top-1_real",
                "T.top-5_real", "U.top-1_infer", "U.top-1_real"]
KEYS = ["Stealth_loss", "d_thr", "Classifier"]


def _sorted_rows(table) -> list:
    """The rows as {column: value}, sorted by ``KEYS`` (compared as
    text, the same order for both tables)."""
    rows = [dict(zip(table.columns, r)) for r in table.typed_rows()]
    return sorted(rows, key=lambda r: tuple(str(r[k]) for k in KEYS))


def compare_success(a, b) -> list:
    """The success columns of two summarize tables (``utils.table.Table``)
    row for row: ``[(column, max |delta|, rows that differ)]`` for each
    column that differs. Raises ValueError when the tables hold other
    (stealth loss, d_thr, classifier) rows."""
    ra, rb = _sorted_rows(a), _sorted_rows(b)
    if [[r[k] for k in KEYS] for r in ra] != \
            [[r[k] for k in KEYS] for r in rb]:
        raise ValueError("the two tables hold different rows")
    diffs = []
    for col in SUCCESS_COLS:
        delta = [abs(float(x[col]) - float(y[col])) for x, y in zip(ra, rb)]
        n = sum(d > 0 for d in delta)
        if n:
            diffs.append((col, max(delta), n))
    return diffs


def report(diffs, n_rows: int) -> int:
    """Print the verdict; the exit code (0 identical, 1 different)."""
    print(f"\n=== bf16 vs f32 success-table comparison ({n_rows} rows x "
          f"{len(SUCCESS_COLS)} success cols) ===")
    if not diffs:
        print("IDENTICAL: every success-rate cell matches.")
        return 0
    for col, mx, n in diffs:
        print(f"DIFFERS: {col}: {n} rows differ, max |delta| = {mx:.4f}")
    return 1


def main(argv=None) -> int:
    from spaa_tpu_torch.bench import default_root

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--setup", default="sim_setup")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    root = args.data_root or os.environ.get("SPAA_BENCH_DATA_ROOT") \
        or default_root()
    data_root = join(root, "sim_benchmark")
    if not isdir(join(data_root, "setups", args.setup)):
        print(f"no trained sim setup under {data_root}; run python -m "
              "spaa_tpu_torch.bench or tools/torch_make_bench_ckpt.py first")
        return 2

    from spaa_tpu_torch.attack import (get_attacker_cfg,
                                       project_capture_real_attack,
                                       run_projector_based_attack,
                                       summarize_single_attacker)
    from spaa_tpu_torch.utils.device import resolve_device
    from spaa_tpu_torch.utils.seed import reset_rng_seeds
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)

    dev = resolve_device(args.device)
    procams = SimProCams(dict(DEFAULT_SIM_SETUP_INFO))  # deterministic
    tables = {}
    for dtype in ("bfloat16", "float32"):
        reset_rng_seeds(0)
        cfg = get_attacker_cfg("SPAA", data_root, [args.setup],
                               load_pretrained=True)
        cfg.attack_dtype = dtype
        run_projector_based_attack(cfg, device=dev)
        project_capture_real_attack(cfg, procams)
        tables[dtype] = summarize_single_attacker(
            "SPAA", data_root, [args.setup],
            stealth_losses=list(cfg.stealth_losses),
            d_threshes=list(cfg.d_threshes),
            classifier_names=list(cfg.classifier_names), device=dev)
    return report(compare_success(tables["bfloat16"], tables["float32"]),
                  len(tables["float32"]))


if __name__ == "__main__":
    raise SystemExit(main())
