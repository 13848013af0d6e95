#!/usr/bin/env python3
"""What the port's spans cost when on, and what they read over a whole
window, in one benchmark cell on the card.

    python3 tools/torch_trace_cost.py --workload resnet18-attack \\
        [--seed N] [--seconds 20] [--order off on on off] [--profile N]
        [--json PATH]

Sets the cell up once as ``python3 -m benchmark.run`` does (no profiler,
no probe spans or events) and runs one iteration (the first sweep, which
keeps the check's copies), then runs a window of ``--seconds`` per entry
of ``--order``: ``off`` with tracing off, ``on`` after
``trace.reset(); trace.enable()``. Prints, per window, the seconds per
iteration (window wall over iterations: readbacks and validations
included in proportion), and for each ``on`` window each span's calls,
median device and host milliseconds and median host self time, and each
parent's median beside the sum of its children's medians (each times its
calls per call of the parent). Ends with the
card's name and power limit and the median per-iteration cost of tracing
(on over off). ``--profile N`` runs each window for N iterations under
``torch.profiler`` instead (the benchmark's ``TraceWindow``) and prints its
device idle share and idle seconds by the innermost span open at each gap:
the spans' names when on, ``outside_spans`` when off. ``--json`` writes the
same as one object.
"""

import argparse
import json
import statistics
import subprocess
import sys
from os.path import abspath, dirname

sys.path.insert(0, dirname(dirname(abspath(__file__))))


def _medians(report: dict) -> dict:
    out = {}
    for name, r in report.items():
        dev = r["device_ms"]
        out[name] = {"calls": r["calls"], "parent": r["parent"],
                     "device_ms": statistics.median(dev) if dev else None,
                     "host_ms": statistics.median(r["host_ms"]),
                     "self_host_ms": statistics.median(r["self_host_ms"])}
    return out


def _children(spans: dict) -> dict:
    """Per parent: its median device ms, and the sum of its children's
    medians, each times its calls per call of the parent."""
    sums = {}
    for name, s in spans.items():
        p = s["parent"]
        if p in spans and s["device_ms"] is not None:
            sums.setdefault(p, 0.0)
            sums[p] += s["device_ms"] * s["calls"] / spans[p]["calls"]
    return {p: {"parent_ms": spans[p]["device_ms"], "children_ms": v}
            for p, v in sums.items()}


def _idle(summary: dict) -> dict:
    """A profiled window's device idle share and its idle seconds by the
    innermost span open at each gap's start (most first)."""
    by = {}
    for name, t in summary["gaps"]:
        key = name.split(":")[0]
        by[key] = by.get(key, 0.0) + t
    return {"idle_pct": 100.0 * (1.0 - summary["busy_s"]
                                 / summary["window_s"]),
            "idle_by_span": sorted(by.items(), key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 13)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--order", nargs="+", default=["off", "on", "on", "off"],
                    choices=["off", "on"])
    ap.add_argument("--profile", type=int, default=None, metavar="N")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness as H
    from spaa_tpu_torch.utils import trace
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    _, _, config, traffic, _ = H.cell_files(args.workload)
    driver = H.driver_class(traffic)(config, traffic, args.seed, "cuda")
    driver.setup()
    driver.window(3600.0, iters=1)      # the first sweep's check copies
    windows = []
    for mode in args.order:
        trace.reset()
        if mode == "on":
            trace.enable()
        tw = H.TraceWindow() if args.profile else None
        if tw:
            tw.start()
        r = driver.window(args.seconds if tw is None else 3600.0,
                          iters=args.profile)
        if tw:
            tw.stop()
        trace.disable()
        w = {"mode": mode, "iters": r["iters"], "wall_s": r["wall_s"],
             "iter_s": r["wall_s"] / max(1, r["iters"])}
        if tw:
            w.update(_idle(tw.summary))
        if mode == "on":
            w["spans"] = _medians(trace.report())
            w["children"] = _children(w["spans"])
        trace.reset()
        windows.append(w)
        print(f"[{mode}] {w['iters']} iterations, {w['iter_s'] * 1e3:.3f} "
              "ms each", flush=True)
        if tw:
            print(f"    idle {w['idle_pct']:.3f}%: " + ", ".join(
                f"{n} {t * 1e3:.2f} ms" for n, t in w["idle_by_span"]))
        for name, s in sorted(w.get("spans", {}).items()):
            print(f"    {name:22s} calls {s['calls']:5d}  device "
                  f"{s['device_ms']!r} ms  host {s['host_ms']:.3f}  self "
                  f"{s['self_host_ms']:.3f}  (in {s['parent']})")
        for p, c in sorted(w.get("children", {}).items()):
            print(f"    {p}: {c['parent_ms']!r} ms, children "
                  f"{c['children_ms']!r} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    off = [w["iter_s"] for w in windows if w["mode"] == "off"]
    on = [w["iter_s"] for w in windows if w["mode"] == "on"]
    cost = (statistics.median(on) / statistics.median(off) - 1.0) \
        if on and off else None
    out = {"workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "card": smi, "windows": windows,
           "tracing_on_cost": cost}
    print(f"card: {smi}; tracing on costs {cost!r} of an iteration")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
