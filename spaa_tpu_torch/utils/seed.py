"""RNG seeding (counterpart of ``spaa_tpu/utils/seed.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch

from spaa_tpu_torch.utils.threefry import prng_key


def reset_rng_seeds(seed: int) -> np.ndarray:
    """Seed python, numpy and torch's global RNGs (ref ``utils.py:70-76``)
    and return ``spaa_tpu``'s root key for the same seed (the numpy form of
    ``jax.random.PRNGKey(seed)``), from which ``PCNet.init_weights`` draws
    ``spaa_tpu``'s initial weights."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return prng_key(seed)
