"""Faults of the PerC-AL+CompenNet++ loop (``drivers/percal_sweep.py``):
the PerC-AL step returns its state, the second half of the batch keeps its
state, the returned projection altered."""

from __future__ import annotations

from benchmark.faults import patched

# _percal_body(logits_fn, inputs, inputs_lab, labels, targeted, cfg, d_thr,
#              projector_variant, i, state)
STATE = 9


def plant(fault: str):
    import torch
    perc_al = "spaa_tpu_torch.attack.perc_al"
    if fault == "unchanged":
        def make(orig):
            def body(*a, **k):
                orig(*a, **k)
                return a[STATE]
            return body
        return patched(perc_al, "_percal_body", make)
    if fault == "half_batch":
        def make(orig):
            def body(*a, **k):
                new, old = orig(*a, **k), a[STATE]
                h = old[0].shape[0] // 2
                return tuple(torch.cat([n[:h], o[h:]]) for n, o in
                             zip(new, old))
            return body
        return patched(perc_al, "_percal_body", make)

    def make(orig):
        def entry(*a, **k):
            cam, prj = orig(*a, **k)
            return cam, torch.clamp(prj + 1e-3, 0.0, 1.0)
        return entry
    return patched("spaa_tpu_torch.attack.orchestrate",
                   "perc_al_compennet_pp", make)
