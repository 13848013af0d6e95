"""The port's spans (``spaa_tpu_torch/utils/trace.py``) on the CPU: the
shared no-op while off, nesting, parents, self time, call counts and
request ids while on, one stack per thread, a ``torch.profiler`` session
leaving them off, their ranges in a profiler's trace, timing events reused
per device, and the spans of a tiny SPAA sweep (outputs bitwise equal with
tracing on and off) and of a few ``train_model`` iterations."""

import contextlib
import os
import random
import sys
import threading
import time
from os.path import dirname, join
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spaa_tpu_torch.attack import orchestrate as TO
from spaa_tpu_torch.attack.spaa import SpaaConfig, spaa_attack_batched
from spaa_tpu_torch.models.classifiers.resnet import ResNet18
from spaa_tpu_torch.models.pcnet import PCNet
from spaa_tpu_torch.train import train as TT
from spaa_tpu_torch.train.pipeline import TrainedModel, make_pcnet_loss
from spaa_tpu_torch.utils import log as L
from spaa_tpu_torch.utils import trace
from spaa_tpu_torch.utils.config import DictConfig
from spaa_tpu_torch.weights import pcnet_state_dict

CKPT = join(dirname(dirname(os.path.abspath(__file__))), "checkpoint",
            "sim_setup_PCNet_l1+ssim_500_24_2000_0.001_0.2_800_0.0001.flax")
CAM_HW, PRJ_HW, CP_SZ, NET_SZ = (48, 64), (32, 32), (40, 40), (32, 32)
SPAA_SPANS = ("spaa.iteration", "pcnet.forward", "classifier.forward",
              "spaa.classifier_vjp", "spaa.colour", "spaa.masks",
              "spaa.pcnet_pullback", "spaa.update")


@pytest.fixture(autouse=True)
def _fresh_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def test_off_records_nothing_and_shares_one_noop():
    assert not trace.enabled()
    a, b = trace.span("x"), trace.span("y", request=3)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with trace.span("x"):
        with trace.span("y"):
            pass
    assert trace.report() == {}


def test_nesting_parents_self_time_calls_and_requests():
    trace.enable()
    assert trace.enabled()
    for i in range(3):
        with trace.span("outer", request=10 + i):
            time.sleep(0.002)
            with trace.span("inner"):
                time.sleep(0.004)
            with trace.span("inner"):
                pass
    with trace.span("root"):
        pass
    with trace.span("root"):
        pass
    trace.disable()
    with trace.span("outer"):
        pass
    r = trace.report()
    assert set(r) == {"outer", "inner", "root"}
    assert r["outer"]["calls"] == 3 and r["inner"]["calls"] == 6
    assert r["outer"]["parent"] is None and r["inner"]["parent"] == "outer"
    assert r["outer"]["requests"] == [10, 11, 12]
    assert r["inner"]["requests"] == [10, 10, 11, 11, 12, 12]
    # a root span without a request is numbered by its own calls
    assert r["root"]["requests"] == [0, 1]
    assert r["outer"]["device_ms"] is None      # no card
    for k in range(3):
        host, own = r["outer"]["host_ms"][k], r["outer"]["self_host_ms"][k]
        children = sum(r["inner"]["host_ms"][2 * k:2 * k + 2])
        assert host >= 6.0 and own >= 2.0
        assert own == pytest.approx(host - children, abs=1e-6)
    assert r["inner"]["self_host_ms"] == r["inner"]["host_ms"]
    trace.reset()
    assert trace.report() == {}


def test_threads_keep_their_own_stacks():
    """Many threads nesting spans under a short switch interval: every
    inner span's parent is its own thread's outer span, and no call is
    lost."""
    trace.enable()
    n_threads, n = 12, 200
    errors = []

    def work(t):
        try:
            for i in range(n):
                with trace.span(f"outer{t}", request=i):
                    with trace.span("inner"):
                        pass
        except Exception as e:      # recorded for the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    r = trace.report()
    assert r["inner"]["calls"] == n_threads * n
    for t in range(n_threads):
        assert r[f"outer{t}"]["calls"] == n
        assert r[f"outer{t}"]["parent"] is None
        assert sorted(r[f"outer{t}"]["requests"]) == list(range(n))
    # each inner span took its request from its own thread's outer span
    assert sorted(r["inner"]["requests"]) == sorted(
        list(range(n)) * n_threads)


def test_a_profiler_session_leaves_tracing_off():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = trace.span("inside")
        with sp:
            torch.ones(4).sum()
    assert sp is trace.span("x") and not trace.enabled()
    assert trace.report() == {}
    assert "inside" not in {e.name for e in prof.events()}


def test_spans_lie_in_a_profiler_trace_unless_annotate_false():
    from torch.profiler import ProfilerActivity, profile
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step", annotate=False):
            with trace.span("inside"):
                torch.ones(4).sum()
    r = trace.report()
    assert set(r) == {"step", "inside"} and r["inside"]["parent"] == "step"
    names = {e.name for e in prof.events()}
    assert "inside" in names and "step" not in names


def test_folded_events_are_reused_per_device(monkeypatch):
    """A finished pair's events go back to its device's free list, and a
    span on that device takes them before it makes new ones."""
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    monkeypatch.setattr(trace, "_free", {})
    rec = trace._Record()
    a, z = Ev(1.0), Ev(3.5)
    trace._done(rec, 1, a, z)
    assert list(rec.device_ms) == [2.5]
    assert trace._event(1) is z and trace._event(1) is a
    assert trace._free == {1: []}


def _small_attack():
    pc = PCNet(out_size=CAM_HW)
    pc.load_state_dict(pcnet_state_dict(L.load_checkpoint(CKPT),
                                        np.float32))
    rng = np.random.default_rng(3)
    scene = torch.tensor(rng.uniform(0.05, 0.95, (1, *CAM_HW, 3)),
                         dtype=torch.float32)
    mask = torch.ones((*CAM_HW, 1))
    mask[:4], mask[:, -6:] = 0.0, 0.0
    trained = TrainedModel(pc.eval().requires_grad_(False), mask, scene,
                           {"prj_im_sz": [PRJ_HW[1], PRJ_HW[0]]}, None,
                           "PCNet")
    torch.manual_seed(0)
    clf = ResNet18().eval().requires_grad_(False)
    clf.input_size = NET_SZ
    b = 6
    args = (scene, torch.full((b, *PRJ_HW, 3), 0.5),
            torch.tensor([3, 14, 0, 3, 14, 0]),
            torch.tensor([True, True, False] * 2),
            torch.tensor([[0.0, 1.0, 0.0]] * 3 + [[0.1, 1.0, 1.0]] * 3),
            torch.tensor([5.0] * 3 + [9.0] * 3))
    return (TO.make_pcnet_fn(trained),
            TO.make_attack_logits_fn(SimpleNamespace(net=clf), CP_SZ), args)


def test_spaa_sweep_spans_and_outputs_equal_on_and_off():
    pcnet_apply, logits_fn, args = _small_attack()
    cfg = SpaaConfig(iters=3, camde_range=(3, 6))
    off = spaa_attack_batched(pcnet_apply, logits_fn, *args, cfg)
    assert trace.report() == {}
    trace.enable()
    on = spaa_attack_batched(pcnet_apply, logits_fn, *args, cfg)
    spaa_attack_batched(pcnet_apply, logits_fn, *args, cfg)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    r = trace.report()
    assert r["spaa.sweep"]["calls"] == 2
    assert r["spaa.sweep"]["requests"] == [0, 1]
    for name in SPAA_SPANS:
        assert r[name]["calls"] == 6, name
        assert r[name]["requests"] == [0, 0, 0, 1, 1, 1], name
    assert r["spaa.iteration"]["parent"] == "spaa.sweep"
    for name in SPAA_SPANS[1:]:
        assert r[name]["parent"] == "spaa.iteration", name


def test_train_model_spans_per_iteration_and_segment():
    rng = np.random.default_rng(4)
    scene = torch.tensor(rng.uniform(0.05, 0.95, (1, *CAM_HW, 3)),
                         dtype=torch.float32)
    mask = torch.ones((*CAM_HW, 1))
    mask[:3], mask[:, -4:] = 0.0, 0.0
    torch.manual_seed(1)
    net = PCNet(out_size=CAM_HW)
    prj = rng.integers(0, 256, (6, *PRJ_HW, 3), dtype=np.uint8)
    cam = rng.integers(0, 256, (6, *CAM_HW, 3), dtype=np.uint8)
    iters, rate = 4, 2
    cfg = DictConfig(dict(max_iters=iters, valid_rate=rate,
                          lr_drop_ratio=0.2, l2_reg=1e-4))
    opt, sched = TT.make_pcnet_optimizer(net, cfg)
    idx = TT.sample_batch_indices(6, 2, iters, random.Random(5))
    evaluator = TT.make_evaluator(lambda x: net(x, scene, mask), prj[:4],
                                  cam[:4], "cpu", chunk_sz=2)
    trace.enable()
    TT.train_model(make_pcnet_loss(net, scene, mask), net, opt, sched,
                   dict(inputs=prj, targets=cam), idx, cfg, "cpu",
                   valid_fn=evaluator)
    r = trace.report()
    assert r["train.iteration"]["requests"] == list(range(iters))
    for name in ("train.gather", "train.pcnet_fwd", "train.loss",
                 "train.backward", "train.optimizer"):
        assert r[name]["calls"] == iters, name
        assert r[name]["parent"] == "train.iteration", name
        assert r[name]["requests"] == list(range(iters)), name
    assert r["train.segment_end"]["requests"] == [2, 4]
    assert r["train.validation"]["calls"] == iters // rate
    assert r["train.validation"]["parent"] == "train.segment_end"
    assert r["valid.chunk"]["calls"] == 2 * (iters // rate)
    assert r["valid.chunk"]["parent"] == "train.validation"


def test_cost_tool_medians_children_and_idle_by_span():
    """``tools/torch_trace_cost.py``'s reductions: a report's medians, each
    parent beside its children's medians scaled to its calls, and a
    profiled window's idle share summed by the span a gap fell in."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_trace_cost", join(dirname(dirname(os.path.abspath(
            __file__))), "tools", "torch_trace_cost.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rep = {"it": {"calls": 2, "parent": None, "device_ms": [10.0, 12.0],
                  "host_ms": [11.0, 13.0], "self_host_ms": [1.0, 3.0]},
           "fwd": {"calls": 4, "parent": "it", "device_ms": [2.0, 3.0, 3.0,
                                                              9.0],
                   "host_ms": [1.0] * 4, "self_host_ms": [1.0] * 4},
           "cpu": {"calls": 1, "parent": "it", "device_ms": None,
                   "host_ms": [5.0], "self_host_ms": [5.0]}}
    m = tool._medians(rep)
    assert m["it"]["device_ms"] == 11.0 and m["fwd"]["device_ms"] == 3.0
    assert m["cpu"]["device_ms"] is None and m["it"]["self_host_ms"] == 2.0
    assert tool._children(m) == {"it": {"parent_ms": 11.0,
                                        "children_ms": 6.0}}
    idle = tool._idle({"busy_s": 0.75, "window_s": 1.0,
                       "gaps": [("fwd:cudaLaunchKernel", 0.1), ("it", 0.05),
                                ("fwd", 0.05), ("outside_spans", 0.05)]})
    assert idle["idle_pct"] == pytest.approx(25.0)
    assert idle["idle_by_span"][0] == ("fwd", pytest.approx(0.15))
    assert {n for n, _ in idle["idle_by_span"]} == {"fwd", "it",
                                                    "outside_spans"}
