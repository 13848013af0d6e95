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


def set_reproducibility(reproducible: bool = False) -> None:
    """The reference's determinism switch (``utils.py:79-81``): PyTorch's
    deterministic kernels and cuDNN's deterministic algorithms on or off.
    ``cudnn.benchmark`` is left as it is. On the card cuBLAS also needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before it starts."""
    torch.use_deterministic_algorithms(reproducible)
    torch.backends.cudnn.deterministic = reproducible
