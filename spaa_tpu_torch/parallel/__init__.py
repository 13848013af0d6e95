"""Setup-parallel training and attack waves (counterpart of
``spaa_tpu/parallel``): device meshes, several setups trained as one
step, and attack waves of one setup per device."""

from spaa_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                          replicate, replicated,
                                          shard_attack_inputs, shard_batch)
from spaa_tpu_torch.parallel.multi_setup import (
    percal_attack_multi_setup, pretrain_compennets_pp_multi_setup,
    pretrain_pcnets_multi_setup, run_percal_attack_multi_setup,
    run_spaa_attack_multi_setup, spaa_attack_multi_setup, stack_setups,
    train_compennet_pp_multi_setup, train_pcnet_multi_setup, unstack_setups)

__all__ = ["batch_sharding", "make_mesh",
           "pretrain_compennets_pp_multi_setup",
           "percal_attack_multi_setup",
           "pretrain_pcnets_multi_setup", "replicate", "replicated",
           "run_percal_attack_multi_setup",
           "run_spaa_attack_multi_setup",
           "shard_attack_inputs", "shard_batch",
           "spaa_attack_multi_setup", "stack_setups",
           "train_compennet_pp_multi_setup", "train_pcnet_multi_setup",
           "unstack_setups"]
