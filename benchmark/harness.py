"""What every cell's run shares: finding the cell's files by name, the
window's deadline, the host spans, the device trace's reduction, the check
that neither JAX nor the JAX package was loaded, and the result line.

Layout (each found by the name ``BENCHMARK.json`` gives):

- ``configs/<config>.json``: a configuration's sizes and sources;
- ``traffic/<traffic>.json``: a traffic mix, naming its driver;
- ``drivers/<driver>.py``: a ``Driver`` class that sets up, runs the
  window and checks the outputs;
- ``faults/<driver>.py``: ``plant(fault)``, the faults planted in the
  program that driver runs, which the check must read as not correct
  (``benchmark.control`` and the tests only, never a run);
- ``limits/<workload>.json``: each compared number's limit for a cell;
- ``metrics/<metric>.py``: ``read(ctx)`` for one metric, ``None`` when
  the cell has nothing it can read;
- ``counts/``: operations and bytes from shapes; ``peaks.json``: the
  chip's published peaks.
"""

from __future__ import annotations

import gzip
import heapq
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from os.path import dirname, join

HERE = dirname(os.path.abspath(__file__))
ROOT = dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "spaa_tpu")


class WindowClosed(Exception):
    """Raised by a probe at the first call into the program after the
    window's deadline (or a warm-up's last iteration)."""


def load_json(*parts) -> dict:
    with open(join(*parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_files(workload: str):
    """(spec, cell, config, traffic, limits) of workload ``workload``."""
    spec = benchmark_spec()
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", workload + ".json")
    return spec, cell, config, traffic, limits


def driver_class(traffic: dict):
    return importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}").Driver


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: dict, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports:
    those that list it, or list no cells and move (or are) an end-to-end
    metric the cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: ``spaa_tpu_torch`` is not
    ``spaa_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def peaks() -> dict:
    return load_json(HERE, "counts", "peaks.json")


def phase_clock(what: str):
    """``lap(name)`` prints the seconds since the last lap to standard
    error, with ``what``: where set-up time goes."""
    last = [time.perf_counter()]

    def lap(name: str):
        now = time.perf_counter()
        print(f"[{what}] {name} {now - last[0]:.3f} s", file=sys.stderr)
        last[0] = now
    return lap


class Deadline:
    """Counts the program's iterations and closes the window: ``tick()``
    raises :class:`WindowClosed` once the host clock passes the deadline,
    or once ``limit`` iterations have run."""

    def __init__(self):
        self.at = None
        self.limit = None
        self.count = 0

    def arm(self, seconds=None, limit=None):
        self.at = None if seconds is None else time.perf_counter() + seconds
        self.limit, self.count = limit, 0

    def tick(self):
        if (self.at is not None and time.perf_counter() >= self.at) or \
                (self.limit is not None and self.count >= self.limit):
            raise WindowClosed
        self.count += 1


class Spans:
    """The benchmark's own host spans (``torch.profiler.record_function``)
    around its calls into the program; entered and left by name so a span
    can open in one callback and close in the next."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.open = {}

    def enter(self, name: str):
        if self.enabled and name not in self.open:
            from torch.profiler import record_function
            rf = record_function(name)
            rf.__enter__()
            self.open[name] = rf

    def leave(self, name: str):
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


class TraceWindow:
    """A ``torch.profiler`` trace of one stretch of the loop, reduced when
    it stops (``summary``) to device busy time, kernel time by name and
    the idle gaps named by the host span and CUDA call they fall in."""

    def __init__(self):
        self.prof = self.summary = None
        self.done = False

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self):
        """Stop tracing (after a synchronize) and reduce the trace at once:
        a later profiler session in the process would clear its events."""
        import torch
        if self.prof is None:
            return
        torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = reduce_trace(events)
        self.done = True

    @property
    def active(self) -> bool:
        return self.prof is not None


class Stretches:
    """The traced run's profiled stretches, each started and stopped at a
    position of the loop: ``plan`` {name: {"start": pos, "stop": pos}}
    ("steady": whole iterations inside the loop, which the per-layer
    metrics read; "boundary": a sweep's end and the next one's start, or a
    validation, whose idle gaps the breakdown adds). Counts the iterations
    and seconds spent traced, which the iteration time leaves out."""

    def __init__(self, plan: dict):
        self.plan = plan
        self.windows = {name: TraceWindow() for name in plan}
        self.iters, self.wall, self._t0 = 0, 0.0, None

    @property
    def active(self) -> bool:
        return any(w.active for w in self.windows.values())

    def at(self, pos):
        """Called before the iteration at ``pos`` runs."""
        for name, w in self.windows.items():
            if w.active and pos == self.plan[name]["stop"]:
                w.stop()
                self.wall += time.perf_counter() - self._t0
            elif not w.active and not w.done and \
                    pos == self.plan[name]["start"]:
                self._t0 = time.perf_counter()
                w.start()
        if self.active:
            self.iters += 1

    def close(self):
        for w in self.windows.values():
            if w.active:
                w.stop()
                self.wall += time.perf_counter() - self._t0

    def summaries(self) -> dict:
        return {name: w.summary for name, w in self.windows.items()}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")


def reduce_trace(events: list) -> dict:
    """From chrome-trace events (microseconds): ``window_s`` (first to last
    event), ``busy_s`` (union of kernel, copy and memset intervals),
    ``kernels`` {name: [count, seconds]}, ``gaps`` [(name, seconds)] of
    every device idle interval, named by the innermost benchmark span
    (``user_annotation``) open on the host at its start, and after a colon
    by the CUDA runtime or driver call that covers most of it, where one
    covers half or more."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                  for e in xs if e.get("cat") in DEVICE_CATS),
                 key=lambda t: t[:2])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs
                   if e.get("cat") == "user_annotation")
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs if e.get("cat") in HOST_API_CATS)
    if not dev:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "gaps": []}
    t0 = min(float(e["ts"]) for e in xs)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    kernels = {}
    for a, z, e in dev:
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += (z - a) * 1e-6
    busy, gaps, end = 0.0, [], t0
    for a, z, _ in dev:
        if a > end:
            gaps.append((end, a))
        if z > end:
            busy += z - max(a, end)
            end = z
    if t1 > end:
        gaps.append((end, t1))

    # one sweep over the gaps (in order) and the calls (by start), keeping
    # the calls that started before the gap's end and end after its start
    names, open_calls, ci = [], [], 0
    for a, z in gaps:
        while ci < len(calls) and calls[ci][0] < z:
            heapq.heappush(open_calls, (calls[ci][1], calls[ci][0],
                                        calls[ci][2]))
            ci += 1
        while open_calls and open_calls[0][0] <= a:
            heapq.heappop(open_calls)
        inner = [sp for sp in spans if sp[0] <= a < sp[1]]
        name = min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner \
            else "outside_spans"
        cover, call = max(((min(z, e) - max(a, b), n)
                           for e, b, n in open_calls), default=(0.0, ""))
        names.append(f"{name}:{call}" if cover >= 0.5 * (z - a) else name)

    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels,
            "gaps": [(n, (z - a) * 1e-6) for n, (a, z) in zip(names, gaps)]}


def breakdown(summary: dict, *more) -> dict:
    """The ten device operations that took most time in ``summary`` and
    the ten longest idle gaps of it and of the ``more`` summaries, as
    [name, seconds]."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted([g for s in (summary, *more) if s for g in s["gaps"]],
                  key=lambda g: -g[1])[:10]
    return {"device_ops": [[k[:160], v[1]] for k, v in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_mean_s(summary, fragment: str):
    """Mean device seconds per launch of the kernels whose name holds
    ``fragment``; None when the trace has none."""
    hits = [v for k, v in (summary or {}).get("kernels", {}).items()
            if fragment in k]
    n, t = sum(h[0] for h in hits), sum(h[1] for h in hits)
    return t / n if n and t > 0 else None

