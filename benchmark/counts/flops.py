"""Multiply-adds of convolutions, transposed convolutions and linear layers,
counted from their shapes.

:func:`count` runs a function (typically a reference network on ``meta``
tensors, so nothing is computed) under a ``TorchFunctionMode`` that sees
every ``F.conv2d``, ``F.conv_transpose2d`` and ``F.linear`` call and adds
up, from the argument shapes:

- ``forward``: the layer's multiply-adds;
- ``input_grad``: the same again where the layer's input requires a
  gradient (the backward to the input is a transposed product of the same
  size);
- ``weight_grad``: the same again where the weight requires a gradient.

A FLOP is two multiply-adds. Elementwise work (activations, colour losses,
the optimizer) is not counted.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def conv_macs(out_shape, weight_shape, groups: int = 1) -> int:
    """Output elements x (input channels per group x kernel area)."""
    n, cout, ho, wo = out_shape
    _, cin_g, kh, kw = weight_shape
    return n * cout * ho * wo * cin_g * kh * kw


def tconv_macs(in_shape, weight_shape, groups: int = 1) -> int:
    """Each input element scatters into kernel area x output channels per
    group; weight is (in, out / groups, kh, kw)."""
    n, cin, hi, wi = in_shape
    _, cout_g, kh, kw = weight_shape
    return n * cin * hi * wi * cout_g * kh * kw


def linear_macs(in_shape, weight_shape) -> int:
    rows = 1
    for d in in_shape[:-1]:
        rows *= d
    return rows * weight_shape[0] * weight_shape[1]


@dataclass
class Macs:
    forward: int = 0
    input_grad: int = 0
    weight_grad: int = 0

    def flops(self, backward: str = "none") -> int:
        """FLOPs of the forward plus ``backward``: 'none', 'input' (the
        gradient to the inputs only) or 'full' (inputs and weights)."""
        macs = self.forward
        if backward in ("input", "full"):
            macs += self.input_grad
        if backward == "full":
            macs += self.weight_grad
        return 2 * macs


class _Counter(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.macs = Macs()

    def _add(self, m: int, x, w):
        self.macs.forward += m
        if x.requires_grad:
            self.macs.input_grad += m
        if w.requires_grad:
            self.macs.weight_grad += m

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is F.conv2d:
            x, w = args[0], args[1]
            self._add(conv_macs(out.shape, w.shape), x, w)
        elif func is F.conv_transpose2d:
            x, w = args[0], args[1]
            self._add(tconv_macs(x.shape, w.shape), x, w)
        elif func is F.linear:
            x, w = args[0], args[1]
            self._add(linear_macs(x.shape, w.shape), x, w)
        return out


def count(fn, *args, **kwargs) -> Macs:
    """Multiply-adds of the layers ``fn(*args, **kwargs)`` calls."""
    counter = _Counter()
    with counter:
        fn(*args, **kwargs)
    return counter.macs


def meta_like(t, requires_grad: bool = False):
    """A ``meta`` tensor of ``t``'s shape and type (nothing allocated)."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta",
                       requires_grad=requires_grad)
