"""Faults of PCNet training (``drivers/pcnet_train.py``): learning rates of
0, the loss as the mean over the first half of the batch, the loss value
altered."""

from __future__ import annotations

from benchmark.faults import patched


def plant(fault: str):
    pipeline = "spaa_tpu_torch.train.pipeline"
    if fault == "unchanged":
        def make(orig):
            def make_opt(model, cfg):
                opt, sched = orig(model, cfg)
                for g in opt.param_groups:
                    g["lr"] = g["initial_lr"] = 0.0
                sched.base_lrs = [0.0] * len(opt.param_groups)
                return opt, sched
            return make_opt
        return patched("spaa_tpu_torch.train.train", "make_pcnet_optimizer",
                       make)
    if fault == "half_batch":
        def make(orig):
            def loss(infer, target, *a, **k):
                h = infer.shape[0] // 2
                return orig(infer[:h], target[:h], *a, **k)
            return loss
        return patched(pipeline, "compute_loss", make)

    def make(orig):
        def loss(*a, **k):
            total, l2 = orig(*a, **k)
            return total * (1.0 + 1e-3), l2
        return loss
    return patched(pipeline, "compute_loss", make)
