"""SPAA sweeps in a closed loop, as ``reproduce_paper_results`` runs them:
one (stealth loss x d_thr) sweep of a classifier after the other, each one
batch of (targets + untargeted) x configs images, from its initial arrays
on the device to ``cam_best`` and ``prj_best`` on the host.

The program's entry is ``spaa_tpu_torch.attack.spaa.spaa_attack_batched``
with PCNet from ``make_pcnet_fn`` (its trained checkpoint, the scene and
the mask read by the benchmark) and the classifier from
``make_attack_logits_fn`` (weights drawn by the benchmark from the seed).
The benchmark wraps both callables: the wrappers count iterations, close
the window, hold the host spans and CUDA events of the traced run, and
keep copies of what the first sweep of the window computes for a sample
of its rows, which the check compares with the plain reference once the
window has closed.
"""

from __future__ import annotations

import importlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.drivers.scene import Scene, import_attr
from benchmark.harness import (Deadline, Spans, Stretches, WindowClosed,
                               phase_clock)
from benchmark.reference import classifiers as RC
from benchmark.reference import pcnet as RP
from benchmark.reference import spaa as RS

# a decision whose margin lies within this of zero may go either way
# under float32 rounding; the check then accepts either outcome
TIE_LOGIT = 1e-3        # times max(1, largest |logit| of the sample)
TIE_PROB = 1e-4
TIE_PERT = 1e-3         # caml2 x 255 against d_thr
TIE_COL = 1e-6          # relative, colour loss against the best so far
MAX_BRANCHES = 32


def stealth_weights(name: str):
    """(prjl2, caml2, camdE) weights of a stealth loss name."""
    return (0.1 if "prjl2" in name else 0.0, 1.0 if "caml2" in name else 0.0,
            1.0 if "camdE" in name else 0.0)


def sweep_layout(traffic: dict, targets, true_idx, prj_hw, brightness):
    """The fused sweep's per-sample arrays (numpy): config after config,
    each its targeted samples then one untargeted; configs with a camdE
    weight last, so CIEDE2000 runs on one contiguous slice. Returns
    ``(prj_init, target, targeted, weights, d_thr, camde_range)``."""
    configs = [(sl, float(d)) for sl in traffic["stealth_losses"]
               for d in traffic["d_threshes"]]
    configs.sort(key=lambda c: stealth_weights(c[0])[2] > 0)
    n = len(targets)
    per = n + 1
    b = len(configs) * per
    tgt = np.zeros(b, np.int64)
    targeted = np.zeros(b, bool)
    w = np.zeros((b, 3), np.float32)
    dt = np.zeros(b, np.float32)
    for ci, (sl, d) in enumerate(configs):
        s = ci * per
        tgt[s:s + n], targeted[s:s + n] = targets, True
        tgt[s + n] = true_idx
        w[s:s + per] = stealth_weights(sl)
        dt[s:s + per] = d
    n_camde = sum(stealth_weights(sl)[2] > 0 for sl, _ in configs)
    prj_init = np.full((b, *prj_hw, 3), brightness, np.float32)
    return prj_init, tgt, targeted, w, dt, ((len(configs) - n_camde) * per,
                                            b)


def _leaf(x):
    """The unclamped projection PCNet's input ``x`` was made from: the one
    leaf of ``x``'s autograd graph, searched through every node, that has
    ``x``'s shape; None where there is no such leaf or more than one."""
    if x.grad_fn is None:
        return None
    found, seen, todo = [], set(), [x.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        var = getattr(fn, "variable", None)
        if var is not None and var.shape == x.shape:
            found.append(var)
        todo.extend(f for f, _ in fn.next_functions)
    return found[0] if len(found) == 1 else None


class Capture:
    """Copies, for rows ``rows`` of every iteration of one sweep, of the
    projection PCNet gets (clamped, and the unclamped leaf under it), the
    camera image it returns and the classifier's logits; into host memory
    (pinned on the card), so the program's device memory is untouched."""

    def __init__(self, rows, iters, prj_hw, cam_hw, device):
        r = len(rows)
        pin = device.type == "cuda"
        self.rows = torch.as_tensor(rows, device=device)

        def buf(*shape):
            return torch.empty(shape, pin_memory=pin)

        self.x = buf(iters, r, *prj_hw, 3)
        self.leaf = buf(iters, r, *prj_hw, 3)
        self.cam = buf(iters, r, *cam_hw, 3)
        self.raw = buf(iters, r, 1000)
        self.has_leaf = np.zeros(iters, bool)
        self.done = 0

    def pcnet(self, k, x, cam):
        nb = x.is_cuda
        self.x[k].copy_(x.detach().index_select(0, self.rows), non_blocking=nb)
        leaf = _leaf(x)
        if leaf is not None:
            self.leaf[k].copy_(leaf.detach().index_select(0, self.rows),
                               non_blocking=nb)
            self.has_leaf[k] = True
        self.cam[k].copy_(cam.detach().index_select(0, self.rows),
                          non_blocking=nb)

    def logits(self, k, raw):
        self.raw[k].copy_(raw.detach().index_select(0, self.rows),
                          non_blocking=raw.is_cuda)
        self.done = k + 1


class Probe:
    """The callables the program gets in place of PCNet's and the
    classifier's: iteration count and deadline, spans, CUDA events of the
    traced run, the trace's start and stop, the capture."""

    def __init__(self, pcnet_apply, logits_fn, trace_plan=None):
        self.pcnet_apply, self.logits_fn = pcnet_apply, logits_fn
        self.deadline = Deadline()
        self.spans = Spans(trace_plan is not None)
        self.traced = Stretches(trace_plan) if trace_plan else None
        self.events = {"pcnet": [], "logits": []}
        self.capture = None
        self.sweep, self.it = -1, 0

    def new_sweep(self):
        self.sweep += 1
        self.it = 0
        self.spans.enter("sweep_start")

    def _timed(self, key, span, fn, arg):
        """``fn(arg)`` inside span ``span``; in the traced run, outside the
        profiled stretches, between two CUDA events kept under ``key``."""
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
            self.events[key].append((a, z))
        return out

    def pcnet(self, x):
        self.spans.leave("sweep_start")
        self.deadline.tick()
        if self.traced is not None:
            self.traced.at([self.sweep, self.it])
        cam = self._timed("pcnet", "pcnet_apply", self.pcnet_apply, x)
        if self.capture is not None and self.sweep == 0:
            self.capture.pcnet(self.it, x, cam)
        return cam

    def logits(self, c):
        raw = self._timed("logits", "logits_fn", self.logits_fn, c)
        if self.capture is not None and self.sweep == 0:
            self.capture.logits(self.it, raw)
        self.it += 1
        return raw

    def close(self):
        for name in list(self.spans.open):
            self.spans.leave(name)
        if self.traced is not None:
            self.traced.close()


def reference_entry(hp_from_cfg):
    """The reference loop with the program entry's signature (the
    control puts it in the program's place)."""
    def entry(pcnet_apply, logits_fn, cam_scene, prj_init, target, targeted,
              weights, d_thr, cfg):
        return RS.attack(pcnet_apply, logits_fn, cam_scene, prj_init, target,
                         targeted, weights, d_thr, hp_from_cfg(cfg))
    return entry


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
        self.hp = RS.Hyper(int(traffic["iters"]), float(traffic["adv_lr"]),
                           float(traffic["col_lr"]), float(traffic["adv_w"]),
                           float(traffic["p_thresh"]))
        self.diagnostics = {}

    def check_iters(self) -> int:
        """Window iterations the check needs: one sweep."""
        return self.hp.iters

    # ------------------------------------------------------------ set-up
    def setup(self):
        dev = self.device
        lap = phase_clock("setup")
        if self.mode == "program":
            from spaa_tpu_torch.utils.device import resolve_device
            resolve_device(dev)
        sc = self.scene_data = Scene(self.config)
        lap("scene, mask")
        rng = np.random.default_rng(self.seed)
        n = int(self.traffic["targets_per_config"])
        classes = rng.choice(1000, n + 1, replace=False)
        prj_init, tgt, targeted, w, dt, camde = sweep_layout(
            self.traffic, classes[:n], int(classes[n]), sc.prj_hw,
            float(self.config["prj_brightness"]))
        per = n + 1
        n_cfg = prj_init.shape[0] // per
        self.rows = np.sort(np.arange(n_cfg) * per
                            + rng.integers(0, per, n_cfg))
        self.step_iters = np.sort(rng.choice(
            self.hp.iters - 1, int(self.traffic["check_steps"]),
            replace=False))

        def t(a, dtype=torch.float32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.arrays = (t(prj_init), t(tgt, torch.long),
                       t(targeted, torch.bool), t(w), t(dt))
        self.scene, self.mask = sc.tensors(dev)
        self.clf_weights = RC.draw_weights(self.config["classifier"],
                                           self.seed, dev)
        self.pcnet_p = sc.pcnet_params(dev)
        lap("inputs, weights")
        if self.mode == "program":
            pcnet_apply, logits_fn, entry = self._program()
        else:
            pcnet_apply, logits_fn, entry = self._control()
        S = importlib.import_module("spaa_tpu_torch.attack.spaa")
        self.cfg = S.SpaaConfig(iters=self.hp.iters, adv_lr=self.hp.adv_lr,
                                col_lr=self.hp.col_lr, adv_w=self.hp.adv_w,
                                p_thresh=self.hp.p_thresh, camde_range=camde)
        self.entry = entry
        lap("program built")
        plan = self.traffic["trace"] if self.trace else None
        self.probe = Probe(pcnet_apply, logits_fn, plan)
        # warm-up: a few iterations at the window's shapes, and a readback
        self.probe.deadline.arm(limit=int(self.traffic["warmup_iters"]))
        try:
            self._sweep_call()
        except WindowClosed:
            pass
        self.arrays[0][:1].cpu()
        lap("warm-up")
        self.probe.sweep, self.probe.it = -1, 0
        self.probe.capture = Capture(self.rows, self.hp.iters, sc.prj_hw,
                                     sc.cam_hw, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lap("capture buffers")

    def _program(self):
        from spaa_tpu_torch.attack.orchestrate import (make_attack_logits_fn,
                                                       make_pcnet_fn)
        from spaa_tpu_torch.models.pcnet import PCNet
        from spaa_tpu_torch.train.pipeline import TrainedModel
        dev, sc = self.device, self.scene_data
        model = PCNet(out_size=sc.cam_hw)
        model.load_state_dict(self.pcnet_p)
        model = model.to(dev).eval()
        for q in model.parameters():
            q.requires_grad_(False)
        setup_info = {"prj_im_sz": list(self.config["prj_im_sz"]),
                      "cam_im_sz": list(self.config["cam_im_sz"]),
                      "classifier_crop_sz":
                          list(self.config["classifier_crop_sz"])}
        trained = TrainedModel(model, self.mask[..., None], self.scene,
                               setup_info, None, "PCNet")
        with torch.device(dev):
            net = import_attr(self.config["port_classifier"])()
        net.load_state_dict(self.clf_weights)
        net = net.eval()
        for q in net.parameters():
            q.requires_grad_(False)
        S = importlib.import_module("spaa_tpu_torch.attack.spaa")

        def entry(*args):
            return S.spaa_attack_batched(*args)

        return (make_pcnet_fn(trained),
                make_attack_logits_fn(SimpleNamespace(net=net),
                                      self.scene_data.crop_hw), entry)

    def _control(self):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.no_grad():
            grid = RP.warp_grid(self.pcnet_p, self.scene_data.cam_hw)
        name, crop = self.config["classifier"], self.scene_data.crop_hw
        p, w = self.pcnet_p, self.clf_weights

        def hp(cfg):
            return RS.Hyper(cfg.iters, cfg.adv_lr, cfg.col_lr, cfg.adv_w,
                            cfg.p_thresh)

        return (lambda x: RP.pcnet(p, grid, self.mask, self.scene, x),
                lambda c: RC.logits(name, w, c, crop), reference_entry(hp))

    def _sweep_call(self):
        return self.entry(self.probe.pcnet, self.probe.logits, self.scene,
                          *self.arrays, self.cfg)

    # ------------------------------------------------------------ window
    def window(self, seconds: float, iters=None) -> dict:
        """Sweeps back to back for ``seconds`` (or ``iters`` iterations)."""
        probe, dev = self.probe, self.device
        self.answers = None
        done = 0
        probe.deadline.arm(seconds=seconds, limit=iters)
        t0 = time.perf_counter()
        try:
            while True:
                probe.new_sweep()
                cam_best, prj_best = self._sweep_call()
                probe.spans.enter("readback")
                cam_h, prj_h = cam_best.cpu(), prj_best.cpu()
                probe.spans.leave("readback")
                if probe.sweep == 0:
                    self.answers = (cam_h[self.rows].clone(),
                                    prj_h[self.rows].clone())
                done += 1
                del cam_best, prj_best, cam_h, prj_h
        except WindowClosed:
            pass
        finally:
            probe.close()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.result = {"iters": probe.deadline.count, "wall_s": wall,
                       "sweeps_done": done, "iters_per_sweep": self.hp.iters,
                       "configs_per_sweep": len(self.traffic["stealth_losses"])
                       * len(self.traffic["d_threshes"])}
        return self.result

    # ------------------------------------------------------------ metrics
    def context(self) -> dict:
        """What the per-layer readers take: event means, the trace, the
        operations and bytes of one iteration from shapes."""
        from benchmark.counts import flops as FC
        from benchmark.counts.warp_bytes import warp_bytes
        probe, sc = self.probe, self.scene_data
        ev = {k: [a.elapsed_time(z) for a, z in v]
              for k, v in probe.events.items()}
        b = self.arrays[0].shape[0]
        meta_p = {k: FC.meta_like(v) for k, v in self.pcnet_p.items()}
        meta_c = {k: FC.meta_like(v) for k, v in self.clf_weights.items()}
        grid_m = torch.empty((1, *sc.cam_hw, 2), device="meta")
        mask_m = torch.empty(sc.cam_hw, device="meta")
        scene_m = torch.empty((1, *sc.cam_hw, 3), device="meta")
        prj_m = torch.empty((b, *sc.prj_hw, 3), device="meta",
                            requires_grad=True)
        cam_m = torch.empty((b, *sc.cam_hw, 3), device="meta",
                            requires_grad=True)
        pc = FC.count(RP.pcnet, meta_p, grid_m, mask_m, scene_m, prj_m)
        cl = FC.count(RC.logits, self.config["classifier"], meta_c, cam_m,
                      sc.crop_hw)
        with torch.no_grad():
            grid = RP.warp_grid(self.pcnet_p, sc.cam_hw)[0].cpu().numpy()
        wb = warp_bytes(grid, sc.prj_hw, sc.mask, b)
        r, traced = self.result, probe.traced
        trace_iters = traced.iters if traced else 0
        trace_wall = traced.wall if traced else 0.0
        stretches = traced.summaries() if traced else {}
        return {
            "kind": self.kind,
            "window": r,
            "iter_s": (r["wall_s"] - trace_wall) / max(1, r["iters"]
                                                       - trace_iters),
            "flops_per_iter": pc.flops("input") + cl.flops("input"),
            "pcnet_ms": ev["pcnet"], "logits_ms": ev["logits"],
            "warp_bytes": wb,
            "trace": stretches.get("steady"),
            "trace_boundary": stretches.get("boundary"),
        }

    # ------------------------------------------------------------ check
    def free_program(self):
        self.probe.pcnet_apply = self.probe.logits_fn = self.entry = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> list:
        """The numbers compared with the plain reference, each with its
        limit; see PERF.md for how each limit was set."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cap, dev, sc = self.probe.capture, self.device, self.scene_data
        n_it = cap.done
        with torch.no_grad():
            grid = RP.warp_grid(self.pcnet_p, sc.cam_hw)
        name, crop, w_c = self.config["classifier"], sc.crop_hw, \
            self.clf_weights

        def ref_pcnet(x):
            return RP.pcnet(self.pcnet_p, grid, self.mask, self.scene, x)

        def ref_logits(c):
            return RC.logits(name, w_c, c, crop)

        rows = torch.as_tensor(self.rows, device=dev)
        prj_init, tgt, targeted, w, dt = (a.index_select(0, rows)
                                          for a in self.arrays)
        b_full = self.arrays[0].shape[0]
        numbers = {"start_gap": None, "pcnet_gap": 0.0, "logits_gap": 0.0,
                   "step_gap": 0.0, "answer_gap": 0.0}
        if n_it:
            # the start the steps are followed from: the initial arrays
            numbers["start_gap"] = float((cap.x[0].to(dev) - torch.clamp(
                prj_init, 0, 1)).abs().max())

        def prj_at(k, why=True):
            """The unclamped projections of iteration k, or None (saying
            why on standard error, where ``why``)."""
            if not cap.has_leaf[k]:
                if why:
                    print(f"[check] iteration {k}: PCNet's input has no one "
                          "leaf of its shape in its autograd graph, so the "
                          "unclamped projection under it (the state the "
                          "step is followed from) is not found; the step "
                          "is not checked", file=sys.stderr)
                return None
            leaf = cap.leaf[k].to(dev)
            if not torch.equal(torch.clamp(leaf, 0, 1), cap.x[k].to(dev)):
                if why:
                    print(f"[check] iteration {k}: the leaf under PCNet's "
                          "input does not clamp to that input; the step is "
                          "not checked", file=sys.stderr)
                return None
            return leaf

        # one step from the program's own state, at sampled iterations
        preds = {}
        for k in [int(k) for k in self.step_iters if k + 1 < n_it] + \
                ([n_it - 1] if n_it == self.hp.iters else []):
            prj = prj_at(k)
            if prj is None:
                continue
            s = RS.step(ref_pcnet, ref_logits, self.scene, prj, prj_init,
                        tgt, targeted, w, dt, b_full, self.hp)
            cam_k = cap.cam[k].to(dev)
            numbers["pcnet_gap"] = max(numbers["pcnet_gap"], float(
                (s["cam"] - cam_k).abs().max()))
            alts = self._step_alternatives(s, targeted)
            preds[k] = [torch.clamp(a, 0, 1) for a in alts]
            if k + 1 < n_it:
                nxt = prj_at(k + 1, why=False)
                if nxt is None:
                    nxt = cap.x[k + 1].to(dev)
                    alts = [torch.clamp(a, 0, 1) for a in alts]
                gaps = [self._rel(nxt - prj, a - prj) for a in alts]
                numbers["step_gap"] = max(numbers["step_gap"], float(
                    torch.stack(gaps).min(0).values.max()))
        # the classifier on every captured camera image
        ref_raw, ref_cols = [], []
        for k in range(n_it):
            cam_k = cap.cam[k].to(dev)
            raw = ref_logits(cam_k)
            scale = torch.clamp(raw.abs().max(1).values, min=1.0)
            numbers["logits_gap"] = max(numbers["logits_gap"], float(
                ((raw - cap.raw[k].to(dev)).abs().max(1).values
                 / scale).max()))
            caml2, camde = RS.colour_losses(cam_k, self.scene, w)
            prjl2 = RS.per_sample_l2(prj_init - cap.x[k].to(dev))
            ref_raw.append(raw)
            ref_cols.append((caml2, camde, prjl2))
        # the answers: the best projection and camera image the replayed
        # bookkeeping keeps, against what the sweep returned
        if self.answers is not None and n_it == self.hp.iters:
            numbers["answer_gap"], last = self._answer_gap(
                cap, ref_raw, ref_cols, tgt, targeted, w, dt, prj_init)
            # a projection kept at the last iteration is that iteration's
            # step, which no later PCNet call shows: check it as a step
            if last and n_it - 1 in preds:
                i = torch.as_tensor(last, device=dev)
                prj = cap.x[n_it - 1].to(dev)[i]
                got = self.answers[1].to(dev)[i]
                gaps = [self._rel(got - prj, a[i] - prj)
                        for a in preds[n_it - 1]]
                numbers["step_gap"] = max(numbers["step_gap"], float(
                    torch.stack(gaps).min(0).values.max()))
        else:
            numbers["answer_gap"] = None
        out = []
        for k, v in numbers.items():
            if v is not None:
                out.append({"name": k, "value": v, "limit": limits[k]})
        out.append({"name": "steps_checked", "value": float(len(preds)),
                    "limit": float(limits["min_steps_checked"]),
                    "at_least": True})
        return out

    @staticmethod
    def _rel(a, b):
        """Per sample ||a - b|| / ||b||."""
        return (a - b).flatten(1).norm(dim=1) / torch.clamp(
            b.flatten(1).norm(dim=1), min=1e-30)

    def _ties(self, succ, conf, pert, raw, targeted):
        scale = torch.clamp(raw.abs().max(1).values, min=1.0)
        return ((succ.abs() < TIE_LOGIT * scale),
                (conf.abs() < TIE_PROB) & targeted,
                (pert.abs() < TIE_PERT))

    def _m_options(self, succ, conf, pert, raw, targeted):
        """Per sample, the set of mask values rounding could give."""
        ts, tc, tp = self._ties(succ, conf, pert, raw, targeted)
        opts = []
        for i in range(succ.shape[0]):
            vals = set()
            for s in ({bool(succ[i] > 0)} | ({True, False} if ts[i] else
                                              set())):
                for c in ({bool(conf[i] > 0)} | ({True, False} if tc[i]
                                                  else set())):
                    for p in ({bool(pert[i] > 0)} | ({True, False} if tp[i]
                                                      else set())):
                        vals.add(s and p and (c or not bool(targeted[i])))
            opts.append(vals)
        return opts

    def _step_alternatives(self, s, targeted):
        """The reference's next projections: its own decision, and per
        sample the other branch where the decision is a tie."""
        m = s["m"][:, None, None, None]
        main = torch.where(m, s["next_col"], s["next_adv"])
        opts = self._m_options(s["succ"], s["conf"], s["pert"], s["raw"],
                               targeted)
        flip = torch.tensor([len(o) > 1 for o in opts],
                            device=m.device)[:, None, None, None]
        other = torch.where(m, s["next_adv"], s["next_col"])
        return [main, torch.where(flip, other, main)]

    def _answer_gap(self, cap, ref_raw, ref_cols, tgt, targeted, w, dt,
                    prj_init):
        """The largest gap between a sample's answer and the pair (camera
        image, next projection) of the iteration the replayed bookkeeping
        keeps (any the ties allow); a projection kept at the last
        iteration is left to the step check. Returns ``(gap, rows kept
        only at the last iteration)``."""
        dev = self.device
        cam_ans, prj_ans = (a.to(dev) for a in self.answers)
        n_it, r = cap.done, len(self.rows)
        hp = self.hp
        # per sample: the set of (best iteration, best colour loss) states
        states = [{(-1, 1e6)} for _ in range(r)]
        for k in range(n_it):
            raw = ref_raw[k]
            caml2, camde, prjl2 = ref_cols[k]
            succ, conf, pert = RS.margins(raw, caml2, tgt, targeted, dt, hp)
            col = w[:, 0] * prjl2 + w[:, 1] * caml2 + w[:, 2] * camde
            m_opts = self._m_options(succ, conf, pert, raw, targeted)
            tie_s = self._ties(succ, conf, pert, raw, targeted)[0]
            for i in range(r):
                s_opts = {bool(succ[i] > 0)} | ({True, False}
                                                if tie_s[i] else set())
                ci = float(col[i])
                nxt = set()
                for kb, cb in states[i]:
                    for m in m_opts[i]:
                        lower = {ci < cb} | ({True, False} if abs(ci - cb)
                                             <= TIE_COL * abs(cb) else set())
                        for lw in lower:
                            better = lw and m
                            for sc in s_opts:
                                keep = sc or better
                                nxt.add((k if keep else kb,
                                         ci if better else cb))
                states[i] = set(sorted(nxt)[:MAX_BRANCHES])
        gap, last = 0.0, []
        scene = self.scene[0]
        for i in range(r):
            best = float("inf")
            kbs = {kb for kb, _ in states[i]}
            if kbs == {n_it - 1}:
                last.append(i)
            for kb in kbs:
                if kb < 0:
                    cam_c, prj_c = scene, torch.clamp(prj_init[i], 0, 1)
                else:
                    cam_c = cap.cam[kb][i].to(dev)
                    prj_c = cap.x[kb + 1][i].to(dev) if kb + 1 < n_it \
                        else prj_ans[i]
                best = min(best, max(float((cam_ans[i] - cam_c).abs().max()),
                                     float((prj_ans[i] - prj_c).abs().max())))
            gap = max(gap, best)
        return gap, last
