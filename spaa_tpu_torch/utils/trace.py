"""The port's spans: named stretches of host and device time at the layer
boundaries of the SPAA iteration and of the training step.

Tracing is off by default, and only ``enable()`` turns it on, for the
process. Off, :func:`span` returns one shared no-op context after one
global read: no allocation, no call into torch.

On, each span

- opens ``torch.profiler.record_function(name)``: inside a profiler
  session the span lies in the trace on the kernels' clock. Spans made
  with ``annotate=False`` open none: those around a loop's step or
  segment, which call back into the caller's closures. A caller may start
  or stop its profiler there, and the profiler ends a range still open at
  its stop only once the stop is done, tens of milliseconds after the
  device's last kernel, which the trace would show as idle device time;
  their child spans name the trace's stretches;
- records its host start and end (``time.perf_counter_ns``), its parent
  (the innermost open span of the same thread: each host thread, as
  ``parallel/`` runs one per card, keeps its own stack) and a request id
  (given, else the parent's, else the span's own call number: the sweep
  number of ``spaa.sweep``);
- where CUDA is initialised, records a pair of timing events on the
  thread's current stream at entry and exit. Nothing synchronises: a pair
  is folded into its name's device milliseconds once ``query()`` says the
  end event is done, and only :func:`report` waits, for the pairs still
  pending. Folded events go back to their device's free list, so a span
  creates none once the first pairs are done.

Each name keeps its last ``KEEP`` calls' times, so memory stays bounded
over a long run; ``calls`` counts them all.

Spans (``tools/torch_trace_cost.py`` reads them over a benchmark cell's
windows):
``spaa.sweep``, ``spaa.iteration``, ``pcnet.forward``,
``classifier.forward``, ``spaa.classifier_vjp``, ``spaa.colour``,
``spaa.masks``, ``spaa.pcnet_pullback``, ``spaa.update``;
``train.iteration``, ``train.gather``, ``train.pcnet_fwd``, ``train.loss``,
``train.backward``, ``train.optimizer``, ``train.segment_end``,
``train.validation``, ``valid.chunk``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.profiler import record_function

KEEP = 1 << 16

_on = False
_NULL = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
_records: dict = {}
_pending: collections.deque = collections.deque()
_free: dict = {}        # device index -> timing events ready to record


def enable():
    """Turn tracing on for the process."""
    global _on
    _on = True


def disable():
    """Turn tracing off (what was recorded stays until :func:`reset`)."""
    global _on
    _on = False


def enabled() -> bool:
    """Whether tracing is on."""
    return _on


def reset():
    """Drop everything recorded so far."""
    with _lock:
        _records.clear()
        _pending.clear()


class _Record:
    __slots__ = ("calls", "host_ms", "self_host_ms", "device_ms", "timed",
                 "requests", "parents")

    def __init__(self):
        self.calls = 0
        self.host_ms = collections.deque(maxlen=KEEP)
        self.self_host_ms = collections.deque(maxlen=KEEP)
        self.device_ms = collections.deque(maxlen=KEEP)
        self.timed = False
        self.requests = collections.deque(maxlen=KEEP)
        self.parents = collections.Counter()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _event(dev: int):
    try:
        return _free[dev].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


def _done(rec, dev, a, z):
    """Fold a finished pair into ``rec`` and free its events (under
    ``_lock``)."""
    rec.device_ms.append(a.elapsed_time(z))
    _free.setdefault(dev, []).extend((a, z))


def _fold():
    """Fold the finished pairs, oldest first (under ``_lock``)."""
    while _pending and _pending[0][3].query():
        _done(*_pending.popleft())


class _Span:
    __slots__ = ("name", "request", "annotate", "parent", "t0", "child_ns",
                 "rf", "dev", "ev")

    def __init__(self, name: str, request, annotate: bool):
        self.name, self.request, self.annotate = name, request, annotate

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.request is None:
            if self.parent is not None:
                self.request = self.parent.request
            else:
                with _lock:
                    rec = _records.get(self.name)
                    self.request = rec.calls if rec is not None else 0
        self.child_ns = 0
        self.rf = None
        if self.annotate:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.ev = None
        if torch.cuda.is_initialized():
            self.dev = torch.cuda.current_device()
            self.ev = _event(self.dev)
            self.ev.record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        end = None
        if self.ev is not None:
            end = _event(self.dev)
            end.record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        with _lock:
            rec = _records.get(self.name)
            if rec is None:
                rec = _records[self.name] = _Record()
            rec.calls += 1
            rec.host_ms.append(dur * 1e-6)
            rec.self_host_ms.append((dur - self.child_ns) * 1e-6)
            rec.requests.append(self.request)
            rec.parents[None if parent is None else parent.name] += 1
            if end is not None:
                rec.timed = True
                _pending.append((rec, self.dev, self.ev, end))
                _fold()
        return False


def span(name: str, request=None, annotate: bool = True):
    """A context manager timing the stretch it encloses under ``name``
    (the shared no-op while tracing is off); ``request`` is the id of the
    work it belongs to (the training iteration of ``train.iteration``);
    ``annotate=False`` puts no range in a profiler's trace."""
    if not _on:
        return _NULL
    return _Span(name, request, annotate)


def report() -> dict:
    """``{name: {"calls", "host_ms", "device_ms", "self_host_ms",
    "parent", "requests"}}`` of what was recorded since the last
    :func:`reset`: per call (the last ``KEEP``) host and device
    milliseconds (``device_ms`` None for a span never timed on a card),
    host self time (the span less its child spans), request ids; the most
    frequent parent's name. Waits for the event pairs still pending."""
    with _lock:
        while _pending:
            _pending[0][3].synchronize()
            _done(*_pending.popleft())
        return {name: {"calls": r.calls, "host_ms": list(r.host_ms),
                       "device_ms": list(r.device_ms) if r.timed else None,
                       "self_host_ms": list(r.self_host_ms),
                       "parent": r.parents.most_common(1)[0][0],
                       "requests": list(r.requests)}
                for name, r in _records.items()}
