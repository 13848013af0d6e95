"""Readings that set a cell's limits, in one process on the card: the
program on sound runs, the control (the plain reference in the program's
place, in TF32 where the configuration states float32 with TF32 off), and
each fault of ``benchmark/faults/<driver>.py`` planted in the program.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 \\
        --modes program control unchanged half_batch answer_altered \\
        [--json readings.json]

Each (mode, seed) sets up anew and runs the window as far as the check
needs (one sweep; training to the window's last checked step), then the
check; prints one JSON line
per reading and, at the end, each number's largest reading per mode.
The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time

from benchmark import harness as H
from benchmark.faults import FAULTS, planted


def reading(workload: str, seed: int, mode: str) -> dict:
    import torch
    spec, cell, config, traffic, limits = H.cell_files(workload)
    drv_cls = H.driver_class(traffic)
    fault = mode if mode in FAULTS else None
    t0 = time.perf_counter()
    plant = planted(traffic["driver"], fault) if fault \
        else contextlib.nullcontext()
    with plant, contextlib.redirect_stdout(sys.stderr):
        drv = drv_cls(config, traffic, seed, "cuda",
                      mode="control" if mode == "control" else "program")
        drv.setup()
        drv.window(None, iters=drv.check_iters())
        drv.free_program()
        checks = drv.check(limits)
    diagnostics = drv.diagnostics
    del drv
    torch.cuda.empty_cache()
    return {"workload": workload, "seed": seed, "mode": mode,
            "seconds": time.perf_counter() - t0,
            "numbers": {c["name"]: c["value"] for c in checks},
            "diagnostics": diagnostics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=["program", "control"])
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        for mode in args.modes:
            r = reading(args.workload, seed, mode)
            rows.append(r)
            print(json.dumps(r), flush=True)
    summary = {}
    for r in rows:
        for k, v in r["numbers"].items():
            s = summary.setdefault(r["mode"], {}).setdefault(k, [])
            s.append(v)
    for mode, nums in summary.items():
        print(json.dumps({"mode": mode, "max": {k: max(v) for k, v in
                                                nums.items()},
                          "min": {k: min(v) for k, v in nums.items()}}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    found = H.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
