"""Faults of the SPAA sweep (``drivers/spaa_sweep.py``): the attack's
second half keeps its state, the sweep's returned projections altered."""

from __future__ import annotations

from benchmark.faults import patched


def plant(fault: str):
    import torch
    spaa = "spaa_tpu_torch.attack.spaa"
    if fault == "unchanged":
        def make(orig):
            def body(*a, **k):
                orig(*a, **k)
                return a[3]
            return body
        return patched(spaa, "_spaa_body", make)
    if fault == "half_batch":
        def make(orig):
            def body(*a, **k):
                new, old = orig(*a, **k), a[3]
                h = old[0].shape[0] // 2
                return tuple(torch.cat([n[:h], o[h:]]) for n, o in
                             zip(new, old))
            return body
        return patched(spaa, "_spaa_body", make)

    def make(orig):
        def entry(*a, **k):
            cam, prj = orig(*a, **k)
            return cam, torch.clamp(prj + 1e-3, 0.0, 1.0)
        return entry
    return patched(spaa, "spaa_attack_batched", make)
