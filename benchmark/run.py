"""Run one cell of the port's benchmark on the card this process sees.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration, traffic mix,
driver and limits by name (see ``benchmark/harness.py``), sets up (inputs
and weights from the seed, a short warm-up), runs the window for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line as the last line of standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics with
``--trace 1``; each compared number beside its limit comes last there and
in the last lines of standard error. The program's own prints go to
standard error. Exits non-zero, printing no result, without a CUDA card,
or if JAX, flax or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import harness as H  # noqa: E402


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _fails(c) -> bool:
    return c["value"] < c["limit"] if c.get("at_least") else \
        not c["value"] <= c["limit"]


def run_cell(workload: str, seed: int, seconds, trace: bool = False,
             device: str = "cuda", config_overrides=None,
             traffic_overrides=None, iters=None):
    """Everything of a run after the look for a card: set-up, window,
    metrics, check. Returns ``(result, checks)``; the overrides and
    ``iters`` (a window of so many iterations) resize a cell for a test on
    the CPU."""
    import torch
    spec, cell, config, traffic, limits = H.cell_files(workload)
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})
    driver = H.driver_class(traffic)(config, traffic, seed, device,
                                     trace=trace)
    on_card = torch.device(device).type == "cuda"
    with contextlib.redirect_stdout(sys.stderr):
        driver.setup()
        setup_s = time.perf_counter() - T0
        driver.window(seconds, iters)
        ctx = driver.context()
        ctx.update(setup_s=setup_s, peaks=H.peaks())
        device_info = {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
            if on_card else 0,
            "power_limit_w": _power_limit_w() if on_card else None}
        driver.free_program()
        checks = driver.check(limits)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in H.cell_metrics(spec, cell, kind):
        v = H.metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": not any(_fails(c) for c in checks),
              "attempted": int(ctx["window"].get("iters", 0)),
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace and ctx.get("trace"):
        device_info.update(busy_s=ctx["trace"]["busy_s"],
                           window_s=ctx["trace"]["window_s"])
        result["breakdown"] = H.breakdown(ctx["trace"],
                                          ctx.get("trace_boundary"))
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _, _ = H.cell_files(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = H.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for c in checks:
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {c['name']} {c['value']!r} (limit {rel} "
              f"{c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
