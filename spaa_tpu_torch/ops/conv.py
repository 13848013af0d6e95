"""Stride-1, pad-1 3x3 convolutions whose forward is routed by shape to
cuDNN's forward engines or to its backward-data engines.

This replaces no TPU kernel: ``spaa_tpu`` leaves ShadingNetSPAA's
convolutions to XLA. On the H100 the port's float32 convolutions (TF32
off, ``utils/device.py::strict_fp32``) are bound by the CUDA cores' fused
multiply-adds, 67 TFLOP/s; their bytes are far below the memory's rate.

Why a backward-data descriptor for a forward: a stride-1, pad-1 3x3
convolution with weight ``W [Cout, Cin, 3, 3]`` equals
``F.conv_transpose2d(x, W.flip(2, 3).transpose(0, 1), padding=1)``, and
cuDNN runs a transposed convolution as the input-gradient (backward-data)
problem of a convolution. For PCNet's 60x80 layers at the attack's batch
cuDNN's heuristic gives the forward its FFT-tiling complex GEMM, at about
a quarter of the float32 peak, and the backward-data problems of the same
sizes implicit-GEMM kernels at about twice that rate: the attack's
pullback runs them every iteration. Which route is faster depends on the
problem, so each key (input shape, weight shape, dtype, bias or not) of a
CUDA device is timed on both routes at its first use, with CUDA events
under ``no_grad`` (2 warm-up calls, the median of 5), and keeps the
transposed route only if it is at least 5% faster: a near tie stays
direct, so that two processes do not part on a marginal key.

The backward makes the call ``F.conv2d``'s autograd makes
(``aten.convolution_backward``), from the same saved input and weight, so
gradients and device memory are as with ``F.conv2d``. CPU tensors run
``F.conv2d`` itself. While ``torch.use_deterministic_algorithms`` is on,
CUDA tensors take the direct route untimed: a route chosen by a clock may
differ between two processes, and such a run has to repeat bit for bit.
"""

from __future__ import annotations

import statistics
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

ROUTES = ("direct", "transposed")
# the transposed route is taken only at or below this share of the direct
# route's median time
WIN_RATIO = 0.95
WARMUP, RUNS = 2, 5

# forward calls on each route since the last reset_launch_counts(), counted
# by Conv3x3S1 as it runs them. One lock guards the counts and the route
# tables: the multi-setup paths run one host thread per card.
LAUNCHES = {r: 0 for r in ROUTES}
_LOCK = threading.Lock()
# device -> key -> (route, direct median ms, transposed median ms)
_TABLES: dict = {}


def reset_launch_counts() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _direct(x, weight, bias):
    return F.conv2d(x, weight, bias, 1, 1)


def _transposed(x, weight, bias):
    return F.conv_transpose2d(x, weight.flip(2, 3).transpose(0, 1), bias,
                              1, 1)


FORWARD = {"direct": _direct, "transposed": _transposed}


class Conv3x3S1(torch.autograd.Function):
    """``F.conv2d(x, weight, bias, padding=1)`` with its forward run on
    ``route`` (one of :data:`ROUTES`) and ``F.conv2d``'s backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, route):
        with _LOCK:
            LAUNCHES[route] += 1
        ctx.save_for_backward(x, weight)
        ctx.bias_sizes = None if bias is None else [bias.shape[0]]
        return FORWARD[route](x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, weight, ctx.bias_sizes, [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


def pick(direct_ms: float, transposed_ms: float) -> str:
    """The route two median times choose."""
    return "transposed" if transposed_ms <= WIN_RATIO * direct_ms \
        else "direct"


def _time_routes(x, weight, bias) -> Tuple[float, float]:
    """Median device ms of one forward call on each route, on x's device
    (CUDA events; the two routes alternate which goes first)."""
    times = {r: [] for r in ROUTES}
    with torch.no_grad(), torch.cuda.device(x.device):
        for _ in range(WARMUP):
            for r in ROUTES:
                FORWARD[r](x, weight, bias)
        for i in range(RUNS):
            for r in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                FORWARD[r](x, weight, bias)
                end.record()
                end.synchronize()
                times[r].append(start.elapsed_time(end))
    return statistics.median(times["direct"]), \
        statistics.median(times["transposed"])


def route_for(x, weight, bias=None) -> str:
    """The route of this call's key on x's device, timed at its first
    use."""
    key = (tuple(x.shape), tuple(weight.shape), x.dtype, bias is not None)
    with _LOCK:
        entry = _TABLES.setdefault(x.device, {}).get(key)
    if entry is None:
        d_ms, t_ms = _time_routes(x, weight, bias)
        with _LOCK:
            entry = _TABLES[x.device].setdefault(key,
                                                 (pick(d_ms, t_ms), d_ms, t_ms))
    return entry[0]


def choices() -> list:
    """Each timed key with its route and the two median times."""
    with _LOCK:
        return [{"device": str(dev), "x": list(key[0]), "weight": list(key[1]),
                 "dtype": str(key[2]).replace("torch.", ""), "bias": key[3],
                 "route": route, "direct_ms": d_ms, "transposed_ms": t_ms}
                for dev, table in _TABLES.items()
                for key, (route, d_ms, t_ms) in table.items()]


def conv3x3_s1(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride=1, padding=1)`` for a 3x3
    ``weight``; on a CUDA tensor its forward takes the route chosen for
    its key."""
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3_s1 takes a 3x3 weight, not "
                         f"{tuple(weight.shape)}")
    if not x.is_cuda:
        return F.conv2d(x, weight, bias, 1, 1)
    route = ("direct" if torch.are_deterministic_algorithms_enabled()
             else route_for(x, weight, bias))
    return Conv3x3S1.apply(x, weight, bias, route)
