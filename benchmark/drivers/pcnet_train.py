"""PCNet training in a closed loop, as ``train_eval_pcnet`` runs it: the
program's ``train_model`` with ``make_pcnet_loss``, ``make_pcnet_optimizer``
(three Adam groups and their LambdaLR) and ``make_evaluator`` (validation
every ``valid_rate`` iterations), on uint8 pairs at the published sizes
drawn on the device from the seed, from PCNet's initial weights drawn by
the benchmark from the seed.

The iteration the loss callable passes on is offset so that every step is
in the l1 + SSIM phase of the curriculum. Set-up runs the first
``check_steps`` steps through ``train_model`` on minibatches whose rows all
differ, with optimizer hooks that keep the first step's gradient (from
Adam's first moment) and the parameters after the last; the window goes on
with the same model and optimizer, in a new ``train_model`` call whose
schedule starts again at update 0. Inside the window the loss callable
copies the parameters and Adam's moments before iterations ``at`` to
``at + steps`` of ``window_check`` (across the first LambdaLR milestone),
and each of those steps' loss. The check follows the set-up's steps from
the initial weights, and the window's from the program's own state there,
with the plain reference.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from benchmark.drivers.scene import Scene
from benchmark.harness import (Deadline, Spans, Stretches, WindowClosed,
                               phase_clock)
from benchmark.reference import train as RT

# leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone and are left out of the comparison
GRAD_FLOOR = 1e-3


def affine_from_corners(corners):
    """The affine taking the mask's first three bounding-box corners to
    (-1, -1), (1, -1), (1, 1) (the published initialisation of PCNet's
    warp), [1, 2, 3]."""
    dst = np.asarray(corners[0:3], np.float64)
    src = np.array([[-1, -1], [1, -1], [1, 1]], np.float64)
    m = np.concatenate([dst, np.ones((3, 1))], axis=1)
    return np.linalg.solve(m, src).T[None].astype(np.float32)


def draw_pcnet_init(shapes: dict, corners, gen, device) -> dict:
    """PCNet's initial parameters from ``gen``, in two draws on the device:
    convolution kernels He-normal, the grid refiner's convolutions
    N(0, 1e-4), transposed convolution kernels U(+-1/sqrt(k*k*in)), biases
    U(+-1/sqrt(fan_in)) with PyTorch's fan-in; the affine from the mask's
    corners, TPS theta 1e-3."""
    normal, uniform = [], []
    for k, shp in shapes.items():
        if not k.endswith((".weight", ".bias")):
            continue
        mod = k.rsplit(".", 1)[0]
        tconv = mod.split(".")[-1].startswith(("transConv", "tconv"))
        wshape = shapes[mod + ".weight"]
        if k.endswith(".weight") and not tconv:
            std = 1e-4 if "grid_refine_net.conv" in k else \
                (2.0 / (wshape[1] * wshape[2] * wshape[3])) ** 0.5
            normal.append((k, std))
        else:
            fan = (wshape[0] if tconv and k.endswith(".weight") else
                   wshape[1]) * wshape[2] * wshape[3]
            uniform.append((k, fan ** -0.5))
    out = {}
    for draws, fn in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [int(torch.Size(shapes[k]).numel()) for k, _ in draws]
        flat = fn(sum(sizes), generator=gen, device=device)
        for (k, s), chunk in zip(draws, torch.split(flat, sizes)):
            x = chunk.view(shapes[k])
            out[k] = x * s if fn is torch.randn else (2 * x - 1) * s
    out["warping_net.affine_mat"] = torch.from_numpy(
        affine_from_corners(corners)).to(device)
    out["warping_net.theta"] = torch.full(shapes["warping_net.theta"], 1e-3,
                                          device=device)
    return out


class Watch:
    """Copies of the training state around the window's checked steps: at
    the loss call of window iterations ``at`` to ``at + steps`` (before that
    iteration's step), the parameters and Adam's moments; the loss of
    iterations ``at`` to ``at + steps - 1``. Each copy stays on the device,
    and nothing is read back inside the window."""

    def __init__(self, model, opt, at: int, steps: int):
        self.model, self.opt = model, opt
        self.at, self.steps = int(at), int(steps)
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.params, self.moments, self.losses = {}, {}, {}

    def before(self, itr: int):
        if not self.at <= itr <= self.at + self.steps or itr in self.params:
            return
        with torch.no_grad():
            self.params[itr] = {n: p.detach().clone() for n, p in
                                self.model.named_parameters()}
            first, second = {}, {}
            for g in self.opt.param_groups:
                for p in g["params"]:
                    st = self.opt.state.get(p, {})
                    if "exp_avg" in st:
                        first[self.names[id(p)]] = st["exp_avg"].clone()
                        second[self.names[id(p)]] = st["exp_avg_sq"].clone()
            self.moments[itr] = (first, second)

    def after(self, itr: int, out):
        if self.at <= itr < self.at + self.steps and itr not in self.losses:
            self.losses[itr] = out[0].detach().clone()

    def complete(self) -> bool:
        return self.at + self.steps in self.params


class Probe:
    """The loss and validation callables ``train_model`` gets: iteration
    count and deadline, the offset into the l1 + SSIM phase, host spans,
    the trace's start and stop, the window's copies (``watch``)."""

    def __init__(self, loss_fn, evaluator, offset: int, trace_plan=None):
        self.loss_fn, self.evaluator, self.offset = loss_fn, evaluator, offset
        self.deadline = Deadline()
        self.spans = Spans(trace_plan is not None)
        self.traced = Stretches(trace_plan) if trace_plan else None
        self.watch = None

    def loss(self, x, y, itr):
        self.spans.leave("training_iteration")
        self.deadline.tick()
        if self.traced is not None:
            self.traced.at(self.deadline.count)
        self.spans.enter("training_iteration")
        if self.watch is not None:
            self.watch.before(itr)
        out = self.loss_fn(x, y, itr + self.offset)
        if self.watch is not None:
            self.watch.after(itr, out)
        return out

    def valid(self):
        self.spans.leave("training_iteration")
        self.spans.enter("validation")
        try:
            return self.evaluator()
        finally:
            self.spans.leave("validation")

    def close(self):
        for name in list(self.spans.open):
            self.spans.leave(name)
        if self.traced is not None:
            self.traced.close()


class Driver:
    """``mode``: "program" (the port) or "control" (the reference's steps
    in TF32 in the program's place; training's readings need no window)."""

    kind = "train"

    def __init__(self, config, traffic, seed, device="cuda", trace=False,
                 mode="program"):
        self.config, self.traffic = config, traffic
        self.seed, self.mode = int(seed), mode
        self.device = torch.device(device)
        self.trace = trace
        self.probe = self.watch = None
        self.diagnostics = {}

    def setup(self):
        dev, tr = self.device, self.traffic
        lap = phase_clock("setup")
        if self.mode == "program":
            from spaa_tpu_torch.utils.device import resolve_device
            resolve_device(dev)
        sc = self.scene_data = Scene(self.config)
        gen = torch.Generator(device=dev).manual_seed(self.seed % 2 ** 63)

        def u8(n, hw):
            return torch.randint(0, 256, (n, *hw, 3), generator=gen,
                                 device=dev, dtype=torch.uint8)

        n_tr, n_va = int(tr["train_pairs"]), int(tr["valid_pairs"])
        self.data = {"inputs": u8(n_tr, sc.prj_hw),
                     "targets": u8(n_tr, sc.cam_hw)}
        self.valid = (u8(n_va, sc.prj_hw), u8(n_va, sc.cam_hw))
        self.scene, self.mask = sc.tensors(dev)
        shapes = {k: tuple(v.shape) for k, v in sc.pcnet_params("cpu").items()}
        self.p0 = draw_pcnet_init(shapes, sc.corners, gen, dev)
        bs, n_chk = int(tr["batch_size"]), int(tr["check_steps"])
        r = random.Random(self.seed)
        first = r.sample(range(n_tr), bs * n_chk)
        rest = [r.sample(range(n_tr), bs) for _ in range(int(tr["max_iters"]))]
        self.plan_check = np.asarray(first, np.int32).reshape(n_chk, bs)
        self.plan = np.asarray(rest, np.int32)
        lap("inputs, data, initial weights")
        if self.mode == "program":
            self._program_setup(n_chk)
        else:
            self.prog = self._control_steps()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lap("first steps")

    def _batches(self, plan):
        """The minibatches of index rows ``plan``, cast as the program's
        loss sees them."""
        idx = [torch.as_tensor(i, device=self.device).long() for i in plan]
        return [(self.data["inputs"][i].float() / 255,
                 self.data["targets"][i].float() / 255) for i in idx]

    def check_iters(self) -> int:
        """Window iterations the check needs: to the last copy."""
        wc = self.traffic["window_check"]
        return int(wc["at"]) + int(wc["steps"]) + 1

    def _control_steps(self):
        """The control in the program's place: the reference's steps in
        TF32, the set-up's and, after ``at`` window iterations from their
        state (a new schedule, Adam's count going on), the window's."""
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        n_chk = len(self.plan_check)
        losses, g1, p3, mom = RT.train_steps(self.p0, self.mask, self.scene,
                                             self._batches(self.plan_check))
        at, n = (int(self.traffic["window_check"][k]) for k in ("at", "steps"))
        p, st = p3, mom
        for j in range(at):
            _, _, p, st = RT.train_steps(p, self.mask, self.scene,
                                         self._batches(self.plan[j:j + 1]),
                                         st, t0=n_chk + j, k0=j)
        w_losses, w_g, w_p, _ = RT.train_steps(
            p, self.mask, self.scene, self._batches(self.plan[at:at + n]), st,
            t0=n_chk + at, k0=at)
        self.control_window = {"p": p, "moments": st, "losses": w_losses,
                               "g": w_g, "p_last": w_p}
        return losses, g1, p3

    def _program_setup(self, n_chk):
        from spaa_tpu_torch.models.pcnet import PCNet
        from spaa_tpu_torch.train.pipeline import make_pcnet_loss
        from spaa_tpu_torch.train.train import (get_model_train_cfg,
                                                make_evaluator,
                                                make_pcnet_optimizer,
                                                train_model)
        dev, sc, tr = self.device, self.scene_data, self.traffic
        model = PCNet(out_size=sc.cam_hw).to(dev)
        model.load_state_dict(self.p0)
        cfg = get_model_train_cfg(["PCNet"], single=True)
        cfg.batch_size = int(tr["batch_size"])
        cfg.valid_rate = int(tr["valid_rate"])
        cfg.max_iters = int(tr["max_iters"])
        opt, sched = make_pcnet_optimizer(model, cfg)
        mask3 = self.mask[..., None]
        scene = self.scene
        evaluator = make_evaluator(lambda x: model(x, scene, mask3),
                                   *self.valid, dev)
        self.probe = Probe(make_pcnet_loss(model, scene, mask3), evaluator,
                           int(tr["iter_offset"]),
                           tr["trace"] if self.trace else None)
        self.run_args = (model, opt, sched, cfg)
        self.train_model = train_model
        # the first steps, through the window's own call
        names = {id(p): n for n, p in model.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        seen = {"steps": 0}
        prog = {"g1": None, "p_last": None}

        def after_step(o, args, kwargs):
            seen["steps"] += 1
            if seen["steps"] == 1:
                prog["g1"] = {names[id(p)]: o.state[p]["exp_avg"].detach()
                              .clone() / (1 - beta1)
                              for g in o.param_groups for p in g["params"]}
            if seen["steps"] == n_chk:
                prog["p_last"] = {n: p.detach().clone()
                                  for n, p in model.named_parameters()}

        hook = opt.register_step_post_hook(after_step)
        losses = []
        cfg_chk = cfg.copy()
        cfg_chk.max_iters = n_chk
        try:
            train_model(self.probe.loss, model, opt, sched, self.data,
                        self.plan_check, cfg_chk, dev,
                        valid_fn=self.probe.valid, step_losses=losses)
        finally:
            hook.remove()
        self.prog = ([float(a) for a, _ in losses], prog["g1"],
                     prog["p_last"])
        wc = tr["window_check"]
        self.probe.watch = Watch(model, opt, wc["at"], wc["steps"])

    def window(self, seconds: float, iters=None) -> dict:
        """``train_model`` for ``seconds`` (or ``iters`` iterations)."""
        if self.mode != "program":
            self.result = {"iters": 0, "wall_s": 0.0}
            return self.result
        model, opt, sched, cfg = self.run_args
        probe, dev = self.probe, self.device
        probe.deadline.arm(seconds=seconds, limit=iters)
        t0 = time.perf_counter()
        try:
            while True:
                self.train_model(probe.loss, model, opt, sched, self.data,
                                 self.plan, cfg, dev, valid_fn=probe.valid)
        except WindowClosed:
            pass
        finally:
            probe.close()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.result = {"iters": probe.deadline.count,
                       "wall_s": time.perf_counter() - t0,
                       "iters_per_setup": int(self.traffic["setup_iters"])}
        return self.result

    def context(self) -> dict:
        from benchmark.counts import flops as FC
        sc, b = self.scene_data, int(self.traffic["batch_size"])
        meta_p = {k: FC.meta_like(v, requires_grad=True)
                  for k, v in self.p0.items()}
        prj = torch.empty((b, *sc.prj_hw, 3), device="meta")
        cam = torch.empty((b, *sc.cam_hw, 3), device="meta")
        macs = FC.count(RT.loss_fn, meta_p, torch.empty(sc.cam_hw,
                                                        device="meta"),
                        torch.empty((1, *sc.cam_hw, 3), device="meta"), prj,
                        cam)
        r, traced = self.result, self.probe.traced
        trace_iters = traced.iters if traced else 0
        trace_wall = traced.wall if traced else 0.0
        stretches = traced.summaries() if traced else {}
        return {"kind": self.kind, "window": r,
                "iter_s": (r["wall_s"] - trace_wall) / max(1, r["iters"]
                                                           - trace_iters),
                "flops_per_iter": macs.flops("full"),
                "trace": stretches.get("steady"),
                "trace_boundary": stretches.get("boundary")}

    def free_program(self):
        if self.probe is not None:
            self.watch, self.probe.watch = self.probe.watch, None
            self.watch.model = self.watch.opt = None
        self.run_args = self.probe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def _gaps(start, losses_p, g_p, p_p, losses_r, g_r, p_r):
        """The numbers of one stage of steps from parameters ``start``:
        each step's loss gap (relative), the first gradient's and the
        change's gap by leaf norm (over max(leaf, median leaf) of the
        reference), over the leaves whose reference gradient is not nought
        to rounding."""
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)]
        gn_r = {k: float(v.norm()) for k, v in g_r.items()}
        med_g = float(np.median(list(gn_r.values())))
        kept = [k for k, v in gn_r.items() if v >= GRAD_FLOOR * med_g]
        grads = [abs(float(g_p[k].norm()) - gn_r[k]) / max(gn_r[k], med_g)
                 for k in kept]
        dn_r = {k: float((p_r[k] - start[k]).norm()) for k in kept}
        med_d = float(np.median(list(dn_r.values())))
        change = {k: abs(float((p_p[k] - start[k]).norm()) - dn_r[k])
                  / max(dn_r[k], med_d) for k in kept}
        worst = max(change, key=change.get)
        return {"loss": gaps, "grad": max(grads),
                "grad_median": float(np.median(grads)), "kept": len(kept),
                "change_median": float(np.median(list(change.values()))),
                "change_worst": change[worst], "worst_leaf": worst}

    def _window_stage(self):
        """(start, losses, first gradient, parameters after) of the
        window's checked steps, the program's or the control's; None when
        the window did not reach them."""
        if self.mode != "program":
            c = self.control_window
            return c["p"], c["moments"], c["losses"], c["g"], c["p_last"]
        w, beta1 = self.watch, RT.BETAS[0]
        if not w.complete():
            return None
        at, n = w.at, w.steps
        start, (m0, v0) = w.params[at], w.moments[at]
        m1 = w.moments[at + 1][0]
        # the first step's gradient as Adam took it, from its first moment
        g = {k: (m1[k] - beta1 * m0[k]) / (1 - beta1) for k in m1}
        losses = [float(w.losses[at + i]) for i in range(n)]
        return start, (m0, v0), losses, g, w.params[at + n]

    def check(self, limits: dict) -> list:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        n_chk = len(self.plan_check)
        ref = RT.train_steps(self.p0, self.mask, self.scene,
                             self._batches(self.plan_check))
        losses_p, g1_p, p_p = self.prog
        first = self._gaps(self.p0, losses_p, g1_p, p_p, *ref[:3])
        wc = self.traffic["window_check"]
        at, n = int(wc["at"]), int(wc["steps"])
        stage = self._window_stage()
        win = None
        if stage is not None:
            start, moments, w_losses, w_g, w_p = stage
            w_ref = RT.train_steps(start, self.mask, self.scene,
                                   self._batches(self.plan[at:at + n]),
                                   moments, t0=n_chk + at, k0=at)
            win = self._gaps(start, w_losses, w_g, w_p, *w_ref[:3])
        else:
            print(f"[check] the window ended before iteration {at + n}: its "
                  "steps are not checked", file=sys.stderr)
        for tag, g in (("set-up", first), ("window", win)):
            if g is not None:
                self.diagnostics[tag] = g
                print(f"[check] {tag}: loss gaps {g['loss']!r}; leaf gradient "
                      f"gap median {g['grad_median']!r}, worst {g['grad']!r}; "
                      f"leaf change gap median {g['change_median']!r}, worst "
                      f"{g['change_worst']!r} ({g['worst_leaf']})",
                      file=sys.stderr)
        numbers = {
            "first_loss_gap": first["loss"][0],
            "loss_gap": max(first["loss"][1:]),
            "grad_gap": first["grad"],
            # the worst leaf's change in the first steps swings from seed
            # to seed (the warp's few small-gradient parameters under
            # Adam's sign-like first steps, in float32 on both sides;
            # PERF.md): the median leaf's is compared
            "change_gap": first["change_median"]}
        if win is not None:
            # the median leaf's gradient and change at steps 99-101: the
            # worst leaf's are ill-conditioned there (TPS theta's gradient
            # is a sum that nearly cancels, the grid refiner's Adam steps
            # nearly cancelled moments: the float32 reference reads up to
            # 0.87 and 0.80 from the float64 one on the same state; PERF.md)
            numbers.update(window_loss_gap=max(win["loss"]),
                           window_grad_gap=win["grad_median"],
                           window_change_gap=win["change_median"])
        out = [{"name": k, "value": v, "limit": limits[k]}
               for k, v in numbers.items()]
        out.append({"name": "leaves_compared",
                    "value": float(min(first["kept"], win["kept"] if win
                                       else 0)),
                    "limit": float(limits["min_leaves_compared"]),
                    "at_least": True})
        return out
