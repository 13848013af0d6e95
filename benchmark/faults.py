"""Faults planted in the program under test, to see that the check reads
them as not correct (``benchmark/tests/test_harness_faults.py`` on the CPU,
``python3 -m benchmark.control`` on the card). Never used by a run of the
benchmark itself.

- ``unchanged``: a step that returns its state unchanged;
- ``half_batch``: half of the batch left out (the attack's second half
  keeps its state; training's loss is the mean over the first half);
- ``answer_altered``: an answer altered where it is produced (the sweep's
  returned projections, training's loss value).

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib

FAULTS = ("unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def _patched(module: str, name: str, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _attack(fault: str):
    import torch
    spaa = "spaa_tpu_torch.attack.spaa"
    if fault == "unchanged":
        def make(orig):
            def body(*a, **k):
                orig(*a, **k)
                return a[3]
            return body
        return _patched(spaa, "_spaa_body", make)
    if fault == "half_batch":
        def make(orig):
            def body(*a, **k):
                new, old = orig(*a, **k), a[3]
                h = old[0].shape[0] // 2
                return tuple(torch.cat([n[:h], o[h:]]) for n, o in
                             zip(new, old))
            return body
        return _patched(spaa, "_spaa_body", make)

    def make(orig):
        def entry(*a, **k):
            cam, prj = orig(*a, **k)
            return cam, torch.clamp(prj + 1e-3, 0.0, 1.0)
        return entry
    return _patched(spaa, "spaa_attack_batched", make)


def _train(fault: str):
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
        return _patched("spaa_tpu_torch.train.train", "make_pcnet_optimizer",
                        make)
    if fault == "half_batch":
        def make(orig):
            def loss(infer, target, *a, **k):
                h = infer.shape[0] // 2
                return orig(infer[:h], target[:h], *a, **k)
            return loss
        return _patched(pipeline, "compute_loss", make)

    def make(orig):
        def loss(*a, **k):
            total, l2 = orig(*a, **k)
            return total * (1.0 + 1e-3), l2
        return loss
    return _patched(pipeline, "compute_loss", make)


def planted(kind: str, fault: str):
    """Context manager: ``fault`` planted in the program a driver of
    ``kind`` ("attack" or "train") runs."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return _attack(fault) if kind == "attack" else _train(fault)
