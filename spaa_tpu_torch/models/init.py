"""``spaa_tpu``'s initial weights for the port's image networks (PCNet,
CompenNet, CompenNet++), drawn without JAX.

flax gives every parameter its own key (``utils/threefry.py``), so a
network's draw depends only on each convolution's module path and shape,
and the port's module names are ``spaa_tpu``'s flax names.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from spaa_tpu_torch.models.warping_net import GridRefineNet
from spaa_tpu_torch.utils import threefry


def draw_spaa_tpu_init(model: nn.Module, rng_key) -> nn.Module:
    """Overwrite every convolution of ``model`` with ``spaa_tpu``'s initial
    weights for the root key ``rng_key`` (``utils.seed.reset_rng_seeds``),
    with the distributions of ``spaa_tpu/models/layers.py`` (reference
    ``models.py:55-58``): convolutions He-normal, except the grid
    refiner's N(0, 1e-4); transposed convolutions U(+-1/sqrt(k*k*in));
    every bias U(+-1/sqrt(fan_in)) with torch's fan_in. Kernels are drawn
    in flax's HWIO layout, each kernel then its bias, under the module's
    name path. Other parameters (WarpingNet's affine and TPS theta) keep
    the constructor's values, as flax's constant initialisers do."""
    refine = {id(m) for g in model.modules() if isinstance(g, GridRefineNet)
              for m in g.modules()}
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            path = name.split(".")
            k_key, b_key = (threefry.param_key(rng_key, path, c)
                            for c in (1, 2))
            if isinstance(m, nn.ConvTranspose2d):
                cin, cout, kh, kw = m.weight.shape
                bound = (kh * kw * cin) ** -0.5
                w = threefry.uniform(k_key, (kh, kw, cin, cout), -bound,
                                     bound).transpose(2, 3, 0, 1)
                fan_bias = kh * kw * cout
            else:
                cout, cin, kh, kw = m.weight.shape
                std = 1e-4 if id(m) in refine \
                    else (2.0 / (kh * kw * cin)) ** 0.5
                w = threefry.normal(k_key, (kh, kw, cin, cout),
                                    std).transpose(3, 2, 0, 1)
                fan_bias = kh * kw * cin
            bound = fan_bias ** -0.5
            m.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            m.bias.copy_(torch.from_numpy(threefry.uniform(
                b_key, (cout,), -bound, bound)))
    return model
