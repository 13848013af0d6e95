"""Attackers and benchmark orchestration (counterpart of
``spaa_tpu/attack/__init__.py``): SPAA, PerC-AL+CompenNet++ and One-pixel
DE, replay and summarize."""

from spaa_tpu_torch.attack.perc_al import PerC_AL, PercALConfig, perc_al_core
from spaa_tpu_torch.attack.spaa import (SpaaConfig, spaa,
                                        spaa_attack_batched, stealth_weights)
from spaa_tpu_torch.attack.one_pixel import (BatchedDE,
                                             DigitalOnePixelAttacker,
                                             ProjectorOnePixelAttacker,
                                             perturb_image_np)
from spaa_tpu_torch.attack.orchestrate import (ATTACKER_NAMES,
                                               get_attacker_cfg,
                                               perc_al_compennet_pp,
                                               project_capture_real_attack,
                                               run_projector_based_attack,
                                               to_attacker_cfg_str)
from spaa_tpu_torch.attack.summarize import (attack_results,
                                             summarize_all_attackers,
                                             summarize_single_attacker)

__all__ = [
    "PerC_AL", "PercALConfig", "perc_al_core",
    "SpaaConfig", "spaa", "spaa_attack_batched", "stealth_weights",
    "BatchedDE", "DigitalOnePixelAttacker", "ProjectorOnePixelAttacker",
    "perturb_image_np",
    "ATTACKER_NAMES", "get_attacker_cfg", "perc_al_compennet_pp",
    "project_capture_real_attack", "run_projector_based_attack",
    "to_attacker_cfg_str", "attack_results", "summarize_all_attackers",
    "summarize_single_attacker",
]
