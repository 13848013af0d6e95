"""PerC-AL+CompenNet++ configs in a closed loop, as ``_run_percal_sweep``
runs them for one classifier: one (stealth loss, d_thr) config after the
other, each one batch of 10 targeted rows and 1 untargeted, from the scene
on the device to ``cam_infer_best`` and ``prj_adv_best`` on the host.

The program's entry is
``spaa_tpu_torch.attack.orchestrate.perc_al_compennet_pp`` with
CompenNet++'s ``TrainedModel.apply`` and the port's classifier, both with
weights drawn by the benchmark from the seed. The entry builds its
classifier callable itself with ``make_attack_logits_fn``; for the length
of each call the driver gives it one that wraps what the program's own
returns. PerC-AL calls that callable twice an iteration (with a gradient,
on the scene plus delta; without, on the quantised image) and once after
the loop (on the kept images). The wrapper counts iterations on the
gradient call, closes the window, holds the host spans and CUDA events of
the traced run, and keeps host copies of what the window's first config
computes: every iteration's delta (the one leaf of the gradient call's
input), quantised image and both calls' logits, which the check compares
with the plain reference once the window has closed.
"""

from __future__ import annotations

import importlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.drivers.pcnet_train import draw_pcnet_init
from benchmark.drivers.scene import Scene, import_attr
from benchmark.drivers.spaa_sweep import TIE_LOGIT, TIE_PERT, TIE_PROB, _leaf
from benchmark.harness import (Deadline, Spans, Stretches, WindowClosed,
                               phase_clock)
from benchmark.reference import classifiers as RC
from benchmark.reference import compennet as RCN
from benchmark.reference import pcnet as RP
from benchmark.reference import perc_al as RPA
from benchmark.reference.color import rgb2lab

# a pre-quantisation value within this many counts of a half count may
# round either way under float32 rounding
TIE_COUNT = 1e-3
# a relative step gap that is not a number (a colour gradient at an
# all-zero map) reads as this
NAN_GAP = 1e3
# WarpingNet's affine at the identity: the corners map to themselves
IDENTITY_CORNERS = [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]


def draw_compennet_pp(gen, device) -> dict:
    """CompenNet++'s parameters as an untrained model starts, from ``gen``
    on ``device``: PCNet's distributions (``draw_pcnet_init``), the affine
    at the identity and the TPS offsets at 0, so the grid stays on the
    image."""
    p = draw_pcnet_init(RCN.shapes(), IDENTITY_CORNERS, gen, device)
    p["warping_net.theta"] = torch.zeros_like(p["warping_net.theta"])
    return p


class Capture:
    """Copies, for every row and iteration of one config, of delta, the
    quantised image and both classifier calls' logits; into host memory
    (pinned on the card), so the program's device memory is untouched."""

    def __init__(self, iters, b, cam_hw, device):
        pin = device.type == "cuda"

        def buf(*shape):
            return torch.empty(shape, pin_memory=pin)

        self.delta = buf(iters, b, *cam_hw, 3)
        self.x_round = buf(iters, b, *cam_hw, 3)
        self.raw_grad = buf(iters, b, 1000)
        self.raw_round = buf(iters, b, 1000)
        self.has_leaf = np.zeros(iters, bool)
        self.done = 0

    def grad_call(self, k, x, raw):
        nb = x.is_cuda
        leaf = _leaf(x)
        if leaf is not None:
            self.delta[k].copy_(leaf.detach(), non_blocking=nb)
            self.has_leaf[k] = True
        self.raw_grad[k].copy_(raw.detach(), non_blocking=nb)

    def round_call(self, k, x, raw):
        nb = x.is_cuda
        self.x_round[k].copy_(x.detach(), non_blocking=nb)
        self.raw_round[k].copy_(raw.detach(), non_blocking=nb)
        self.done = k + 1


class Probe:
    """Wraps the classifier callables the program builds: iteration count
    and deadline, spans, CUDA events of the traced run, the trace's start
    and stop, the capture."""

    def __init__(self, trace_plan=None):
        self.deadline = Deadline()
        self.spans = Spans(trace_plan is not None)
        self.traced = Stretches(trace_plan) if trace_plan else None
        self.events = []
        self.capture = None
        self.config, self.it, self.k = -1, 0, 0
        self.round_next = False

    def new_config(self):
        self.config += 1
        self.it = 0
        self.spans.enter("config_start")

    def wrap(self, fn):
        def logits_fn(im):
            return self.logits(fn, im)
        return logits_fn

    def logits(self, fn, im):
        cap = self.capture if self.config == 0 else None
        if im.requires_grad:
            for name in ("config_start", "iteration"):
                self.spans.leave(name)
            self.deadline.tick()
            self.k, self.it = self.it, self.it + 1
            if self.traced is not None:
                self.traced.at([self.config, self.k])
            self.spans.enter("iteration")
            raw = self._timed("logits_grad", fn, im)
            if cap is not None:
                cap.grad_call(self.k, im, raw)
            self.round_next = True
            return raw
        if self.round_next:
            self.round_next = False
            raw = self._timed("logits_round", fn, im)
            if cap is not None:
                cap.round_call(self.k, im, raw)
            return raw
        self.spans.leave("iteration")
        self.spans.enter("config_end")
        return self._timed("logits_kept", fn, im)

    def _timed(self, span, fn, arg):
        """``fn(arg)`` inside span ``span``; in the traced run, outside the
        profiled stretches, between two CUDA events."""
        rec = self.traced is not None and not self.traced.active
        if rec:
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
        self.spans.enter(span)
        out = fn(arg)
        self.spans.leave(span)
        if rec:
            z.record()
            self.events.append((a, z))
        return out

    def close(self):
        for name in list(self.spans.open):
            self.spans.leave(name)
        if self.traced is not None:
            self.traced.close()


class Driver:
    """``mode``: "program" (the port) or "control" (the plain reference in
    the program's place, in TF32)."""

    kind = "attack"

    def __init__(self, config, traffic, seed, device="cuda", trace=False,
                 mode="program"):
        self.config, self.traffic = config, traffic
        self.seed, self.mode = int(seed), mode
        self.device = torch.device(device)
        self.trace = trace
        self.hp = RPA.Hyper(int(traffic["iters"]),
                            float(traffic["alpha_l_init"]),
                            float(traffic["alpha_c_init"]),
                            float(traffic["confidence"]),
                            float(traffic["p_thresh"]))
        self.diagnostics = {}

    def check_iters(self) -> int:
        """Window iterations the check needs: one config."""
        return self.hp.iters

    # ------------------------------------------------------------ set-up
    def setup(self):
        dev = self.device
        lap = phase_clock("setup")
        if self.mode == "program":
            from spaa_tpu_torch.utils.device import resolve_device
            resolve_device(dev)
        sc = self.scene_data = Scene(self.config)
        lap("scene")
        rng = np.random.default_rng(self.seed)
        n = int(self.traffic["targets_per_config"])
        self.labels_np = rng.choice(1000, n + 1, replace=False)
        self.targeted_np = np.array([True] * n + [False])
        self.step_iters = np.sort(rng.choice(
            self.hp.iters - 1, int(self.traffic["check_steps"]),
            replace=False))
        self.d_thr = float(self.traffic["d_thr"])
        self.scene, _ = sc.tensors(dev)
        self.clf_weights = RC.draw_weights(self.config["classifier"],
                                           self.seed, dev)
        gen = torch.Generator(device=dev).manual_seed(
            (2 * self.seed + 1) % 2 ** 63)
        self.compen_p = draw_compennet_pp(gen, dev)
        lap("inputs, weights")
        self.probe = Probe(self.traffic["trace"] if self.trace else None)
        self.entry = self._program() if self.mode == "program" \
            else self._control()
        lap("program built")
        # warm-up: one whole config at the window's shapes, and a readback
        for t in self.entry():
            t.cpu()
        self.probe.close()
        self.probe = Probe(self.traffic["trace"] if self.trace else None)
        lap("warm-up")
        self.probe.capture = Capture(self.hp.iters, n + 1, sc.cam_hw, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lap("capture buffers")

    def _program(self):
        from spaa_tpu_torch.models.compen_net import CompenNetPlusplus
        from spaa_tpu_torch.train.pipeline import TrainedModel
        dev, sc = self.device, self.scene_data
        model = CompenNetPlusplus(out_size=sc.prj_hw)
        model.load_state_dict(self.compen_p)
        model = model.to(dev).eval()
        for q in model.parameters():
            q.requires_grad_(False)
        setup_info = {k: list(self.config[k]) for k in
                      ("prj_im_sz", "cam_im_sz", "classifier_crop_sz")}
        trained = TrainedModel(model, None, self.scene, setup_info, None,
                               "CompenNet++")
        with torch.device(dev):
            net = import_attr(self.config["port_classifier"])()
        net.load_state_dict(self.clf_weights)
        net = net.eval()
        for q in net.parameters():
            q.requires_grad_(False)
        classifier = SimpleNamespace(net=net)
        labels = [int(v) for v in self.labels_np]
        O = importlib.import_module("spaa_tpu_torch.attack.orchestrate")

        def entry():
            real = O.make_attack_logits_fn

            def make(*a, **k):
                return self.probe.wrap(real(*a, **k))

            O.make_attack_logits_fn = make
            try:
                # the ImageNet labels only name the class the program
                # prints after the loop; the benchmark has none ("?")
                return O.perc_al_compennet_pp(
                    trained.apply, classifier, {}, labels, self.targeted_np,
                    self.scene, self.d_thr, setup_info,
                    max_iterations=self.hp.iters)
            finally:
                O.make_attack_logits_fn = real

        return entry

    def _control(self):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        sc, dev, p = self.scene_data, self.device, self.compen_p
        name, w = self.config["classifier"], self.clf_weights
        b = len(self.labels_np)
        with torch.no_grad():
            grid = RP.warp_grid(p, sc.prj_hw)
        labels, targeted, d_thr = self._rows()

        def entry():
            scene_b = self.scene.expand(b, -1, -1, -1).contiguous()
            logits_fn = self.probe.wrap(
                lambda c: RC.logits(name, w, c, sc.crop_hw))
            cam = RPA.attack(logits_fn, scene_b, labels, targeted, d_thr,
                             self.hp)
            with torch.no_grad():
                return cam, RCN.compennet_pp(p, grid, cam, self.scene)

        return entry

    def _rows(self):
        dev = self.device
        b = len(self.labels_np)
        return (torch.as_tensor(self.labels_np, dtype=torch.long,
                                device=dev),
                torch.as_tensor(self.targeted_np, device=dev),
                torch.full((b,), self.d_thr, device=dev))

    # ------------------------------------------------------------ window
    def window(self, seconds: float, iters=None) -> dict:
        """Configs back to back for ``seconds`` (or ``iters`` iterations)."""
        probe, dev = self.probe, self.device
        self.answers = None
        done = 0
        probe.deadline.arm(seconds=seconds, limit=iters)
        t0 = time.perf_counter()
        try:
            while True:
                probe.new_config()
                cam, prj = self.entry()
                if probe.it == 0:
                    raise RuntimeError(
                        "the program never called the classifier callable "
                        "it built with make_attack_logits_fn, so the window "
                        "cannot count its iterations")
                for name in ("iteration", "config_end"):
                    probe.spans.leave(name)
                probe.spans.enter("readback")
                cam_h, prj_h = cam.cpu(), prj.cpu()
                probe.spans.leave("readback")
                if probe.config == 0:
                    self.answers = (cam_h, prj_h)
                done += 1
                del cam, prj, cam_h, prj_h
        except WindowClosed:
            pass
        finally:
            probe.close()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.result = {"iters": probe.deadline.count, "wall_s": wall,
                       "configs_done": done,
                       "iters_per_sweep": self.hp.iters,
                       "configs_per_sweep": 1}
        return self.result

    # ------------------------------------------------------------ metrics
    def context(self) -> dict:
        """What the per-layer readers take: event means, the trace, the
        operations of one iteration from shapes."""
        from benchmark.counts import flops as FC
        probe, sc = self.probe, self.scene_data
        b = len(self.labels_np)
        meta_c = {k: FC.meta_like(v) for k, v in self.clf_weights.items()}
        meta_p = {k: FC.meta_like(v) for k, v in self.compen_p.items()}
        cam_g = torch.empty((b, *sc.cam_hw, 3), device="meta",
                            requires_grad=True)
        cam = torch.empty((b, *sc.cam_hw, 3), device="meta")
        scene_m = torch.empty((1, *sc.cam_hw, 3), device="meta")
        grid_m = torch.empty((1, *sc.prj_hw, 2), device="meta")
        name = self.config["classifier"]
        # the gradient call (forward and input gradient), the quantised
        # image's forward, and CompenNet++ once a config
        cl_grad = FC.count(RC.logits, name, meta_c, cam_g, sc.crop_hw)
        cl = FC.count(RC.logits, name, meta_c, cam, sc.crop_hw)
        cn = FC.count(RCN.compennet_pp, meta_p, grid_m, cam, scene_m)
        r, traced = self.result, probe.traced
        trace_iters = traced.iters if traced else 0
        trace_wall = traced.wall if traced else 0.0
        stretches = traced.summaries() if traced else {}
        return {
            "kind": self.kind,
            "window": r,
            "iter_s": (r["wall_s"] - trace_wall) / max(1, r["iters"]
                                                       - trace_iters),
            "flops_per_iter": cl_grad.flops("input") + cl.flops("none")
            + cn.flops("none") / self.hp.iters,
            "logits_ms": [a.elapsed_time(z) for a, z in probe.events],
            "trace": stretches.get("steady"),
            "trace_boundary": stretches.get("boundary"),
        }

    # ------------------------------------------------------------ check
    def free_program(self):
        self.entry = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> list:
        """The numbers compared with the plain reference, each with its
        limit; see PERF.md for how each limit was set."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cap, dev, sc, hp = self.probe.capture, self.device, \
            self.scene_data, self.hp
        n_it = cap.done
        name, w = self.config["classifier"], self.clf_weights

        def ref_logits(c):
            return RC.logits(name, w, c, sc.crop_hw)

        labels, targeted, d_thr = self._rows()
        b = labels.shape[0]
        inputs = self.scene.expand(b, -1, -1, -1).contiguous()
        with torch.no_grad():
            inputs_lab = rgb2lab(inputs)
        numbers = {"start_gap": None, "logits_gap": 0.0, "step_gap": 0.0,
                   "compen_gap": None, "answer_gap": None}
        missing = [k for k in range(n_it) if not cap.has_leaf[k]]
        if missing:
            print(f"[check] iterations {missing}: the classifier's gradient "
                  "call has no one leaf of its input's shape in its autograd "
                  "graph, so delta (the state the step is followed from) is "
                  "not found; those steps are not checked", file=sys.stderr)
        if n_it and cap.has_leaf[0]:
            numbers["start_gap"] = float(cap.delta[0].abs().max())

        def delta(k):
            return cap.delta[k].to(dev)

        # the classifier on both calls' inputs of every iteration
        ref_round = []
        with torch.no_grad():
            for k in range(n_it):
                pairs = [(cap.x_round[k].to(dev), cap.raw_round[k])]
                if cap.has_leaf[k]:
                    pairs.append((inputs + delta(k), cap.raw_grad[k]))
                for i, (x, got) in enumerate(pairs):
                    raw = ref_logits(x)
                    if i == 0:
                        ref_round.append(raw)
                    scale = torch.clamp(raw.abs().max(1).values, min=1.0)
                    numbers["logits_gap"] = max(numbers["logits_gap"], float(
                        ((raw - got.to(dev)).abs().max(1).values
                         / scale).max()))

        # one step from the program's own state, at sampled iterations
        checked = 0
        for k in (int(k) for k in self.step_iters):
            if not (k + 1 < n_it and cap.has_leaf[k] and cap.has_leaf[k + 1]):
                continue
            d_k, d_next = delta(k), delta(k + 1)
            if k == 0:
                m = torch.zeros(b, dtype=torch.bool, device=dev)
                flip = m
            else:
                m, flip = self._mask_options(ref_round[k - 1], d_k, labels,
                                             targeted, d_thr)
            nxt_adv, nxt_col = RPA.step(ref_logits, inputs, inputs_lab, d_k,
                                        labels, targeted, k, hp)
            mm, ff = m[:, None, None, None], flip[:, None, None, None]
            main = torch.where(mm, nxt_col, nxt_adv)
            alts = [main, torch.where(ff, torch.where(mm, nxt_adv, nxt_col),
                                      main)]
            gaps = torch.stack([self._rel(d_next - a, a - d_k) for a in alts])
            gaps = torch.nan_to_num(gaps, nan=NAN_GAP).min(0).values
            numbers["step_gap"] = max(numbers["step_gap"],
                                      float(gaps.max()),
                                      self._quant_gap(inputs + d_next,
                                                      cap.x_round[k].to(dev)))
            checked += 1

        # the answers: the kept images against the replayed bookkeeping,
        # and the projections against CompenNet++ on them
        if self.answers is not None and n_it == hp.iters:
            cam_ans, prj_ans = (a.to(dev) for a in self.answers)
            numbers["answer_gap"] = self._answer_gap(cap, ref_round, cam_ans,
                                                     inputs, labels, targeted)
            with torch.no_grad():
                grid = RP.warp_grid(self.compen_p, sc.prj_hw)
                ref = RCN.compennet_pp(self.compen_p, grid, cam_ans,
                                       self.scene)
            numbers["compen_gap"] = float((ref - prj_ans).abs().max())
        out = []
        for k, v in numbers.items():
            if v is not None:
                out.append({"name": k, "value": v, "limit": limits[k]})
        out.append({"name": "steps_checked", "value": float(checked),
                    "limit": float(limits["min_steps_checked"]),
                    "at_least": True})
        return out

    @staticmethod
    def _rel(a, b):
        """Per sample ||a|| / ||b||."""
        return a.flatten(1).norm(dim=1) / torch.clamp(b.flatten(1).norm(dim=1),
                                                      min=1e-30)

    @staticmethod
    def _quant_gap(v, got):
        """Counts by which the quantised image ``got`` differs from the
        reference's quantisation of ``v``, one count forgiven where v lies
        within rounding of a half count."""
        counts = v * 255.0
        tie = (counts - torch.floor(counts) - 0.5).abs() < TIE_COUNT
        diff = torch.round((got - RPA.quantize(v)).abs() * 255.0)
        return float(torch.clamp(diff - tie.to(diff.dtype), min=0).max())

    def _mask_options(self, raw, d, labels, targeted, d_thr):
        """The previous iteration's best-adversarial mask from its logits
        and the delta it left, and per sample whether rounding could give
        the other value."""
        succ, conf, pert = RPA.margins(raw, d, labels, targeted, d_thr,
                                       self.hp)
        scale = torch.clamp(raw.abs().max(1).values, min=1.0)
        ties = (succ.abs() < TIE_LOGIT * scale,
                (conf.abs() < TIE_PROB) & targeted, pert.abs() < TIE_PERT)
        m = RPA.best_adv(succ, conf, pert, targeted)
        flip = torch.zeros_like(m)
        for i in range(m.shape[0]):
            vals = set()
            for s in self._options(RPA.adversarial(succ, targeted)[i],
                                   ties[0][i]):
                for c in self._options(conf[i] > 0, ties[1][i]):
                    for p in self._options(pert[i] > 0, ties[2][i]):
                        vals.add(s and p and (c or not bool(targeted[i])))
            flip[i] = len(vals) > 1
        return m, flip

    @staticmethod
    def _options(value, tie):
        return {bool(value)} | ({True, False} if bool(tie) else set())

    def _answer_gap(self, cap, ref_round, cam_ans, inputs, labels, targeted):
        """Per sample, the kept image is the quantised image of the last
        iteration at which it was adversarial (the scene where none was;
        any iteration the ties allow); the largest gap between the
        returned image and the nearest such candidate."""
        b = labels.shape[0]
        kept = [{-1} for _ in range(b)]
        for k, raw in enumerate(ref_round):
            succ = RPA.success(raw, labels, targeted, self.hp)
            adv = RPA.adversarial(succ, targeted)
            ties = succ.abs() < TIE_LOGIT * torch.clamp(
                raw.abs().max(1).values, min=1.0)
            for i in range(b):
                opts = self._options(adv[i], ties[i])
                kept[i] = ({k} if True in opts else set()) | \
                    (kept[i] if False in opts else set())
        gap = 0.0
        for i in range(b):
            best = min(float((cam_ans[i] - (inputs[i] if kb < 0 else
                                            cap.x_round[kb][i].to(
                                                self.device))).abs().max())
                       for kb in kept[i])
            gap = max(gap, best)
        return gap
