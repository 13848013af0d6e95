"""Port check: the routed stride-1 3x3 convolution (``ops/conv.py``).

Both routes are reached through the module's own functions
(``Conv3x3S1.apply`` with a route, ``route_for`` with its timer replaced):
- the transposed forward equals ``F.conv2d`` at ShadingNetSPAA's keys, at a
  small batch and size: <=1e-12 in float64, <=1e-5 relative in float32;
- gradcheck in float64 on x, weight and bias, and the gradients equal
  ``F.conv2d``'s (the same ``aten.convolution_backward`` call);
- the chooser keeps a tie on the direct route and times a key once;
  ``LAUNCHES`` counts by route; CPU tensors take ``F.conv2d`` uncounted;
- ShadingNetSPAA on either route equals its plain path, <=1e-12 in float64;
- the benchmark's step check (``spaa_sweep._leaf``) still finds the
  unclamped projection under a ``make_pcnet_fn`` graph built through the
  routed node.
"""

import pytest
import torch
import torch.nn.functional as F

from benchmark.drivers.spaa_sweep import _leaf
from spaa_tpu_torch.attack.orchestrate import make_pcnet_fn
from spaa_tpu_torch.models.pcnet import PCNet
from spaa_tpu_torch.models.shading_net import ShadingNetSPAA
from spaa_tpu_torch.ops import conv
from spaa_tpu_torch.train.pipeline import TrainedModel

# ShadingNetSPAA's (Cin, Cout) keys: conv3/conv3_s/skipConv3, conv4/conv4_s,
# conv5, conv6, skipConv1_2/skipConv1_4
KEYS = [(64, 128), (128, 256), (256, 128), (32, 3), (3, 3)]


def _inputs(cin, cout, dtype, n=2, h=6, w=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, cin, h, w), generator=g, dtype=dtype)
    wt = (torch.rand((cout, cin, 3, 3), generator=g, dtype=dtype) - 0.5) \
        / (3 * cin ** 0.5)
    b = torch.rand((cout,), generator=g, dtype=dtype) - 0.5
    return x, wt, b


def _routed(route):
    def fn(x, weight, bias=None):
        return conv.Conv3x3S1.apply(x, weight, bias, route)
    return fn


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("cin,cout", KEYS)
def test_transposed_forward_equals_conv2d(cin, cout, dtype, tol):
    x, wt, b = _inputs(cin, cout, dtype)
    ref = F.conv2d(x, wt, b, 1, 1)
    for bias in (b, None):
        got = conv.Conv3x3S1.apply(x, wt, bias, "transposed")
        want = ref if bias is not None else F.conv2d(x, wt, None, 1, 1)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= \
            tol * float(want.abs().max())


@pytest.mark.parametrize("route", conv.ROUTES)
@pytest.mark.parametrize("cin,cout", KEYS)
def test_gradients_are_conv2d_gradients(cin, cout, route):
    x, wt, b = (t.requires_grad_(True)
                for t in _inputs(cin, cout, torch.float64))
    gy = torch.randn((2, cout, 6, 8), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(conv.Conv3x3S1.apply(x, wt, b, route),
                              (x, wt, b), gy)
    want = torch.autograd.grad(F.conv2d(x, wt, b, 1, 1), (x, wt, b), gy)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    # the frozen case: only the input's gradient is asked for
    wt.requires_grad_(False)
    b.requires_grad_(False)
    gx, = torch.autograd.grad(conv.Conv3x3S1.apply(x, wt, b, route), x, gy)
    assert torch.equal(gx, want[0])


@pytest.mark.parametrize("route", conv.ROUTES)
@pytest.mark.parametrize("cin,cout", [(2, 4), (4, 2), (3, 3)])
def test_gradcheck(cin, cout, route):
    x, wt, b = (t.requires_grad_(True)
                for t in _inputs(cin, cout, torch.float64, n=2, h=4, w=5))
    assert torch.autograd.gradcheck(_routed(route), (x, wt, b))


def test_chooser_keeps_ties_direct_and_times_once(monkeypatch):
    assert conv.pick(10.0, 10.0) == "direct"
    assert conv.pick(10.0, 9.6) == "direct"
    assert conv.pick(10.0, 11.0) == "direct"
    assert conv.pick(10.0, 9.5) == "transposed"
    assert conv.pick(10.0, 5.0) == "transposed"

    timed = []

    def fake(x, weight, bias):
        timed.append(tuple(weight.shape))
        return {3: (4.0, 4.0), 256: (8.0, 4.0)}[weight.shape[0]]

    monkeypatch.setattr(conv, "_TABLES", {})
    monkeypatch.setattr(conv, "_time_routes", fake)
    x3, w3, b3 = _inputs(32, 3, torch.float32)
    x2, w2, b2 = _inputs(128, 256, torch.float32)
    for _ in range(3):
        assert conv.route_for(x3, w3, b3) == "direct"
        assert conv.route_for(x2, w2, b2) == "transposed"
    assert timed == [(3, 32, 3, 3), (256, 128, 3, 3)]
    assert sorted((c["weight"][0], c["route"], c["direct_ms"],
                   c["transposed_ms"]) for c in conv.choices()) == \
        [(3, "direct", 4.0, 4.0), (256, "transposed", 8.0, 4.0)]
    # another batch is another key
    assert conv.route_for(torch.cat([x3, x3]), w3, b3) == "direct"
    assert len(timed) == 3


def test_launches_count_by_route_and_cpu_takes_conv2d():
    x, wt, b = _inputs(4, 8, torch.float32)
    conv.reset_launch_counts()
    for route in ("direct", "transposed", "transposed"):
        conv.Conv3x3S1.apply(x, wt, b, route)
    assert conv.LAUNCHES == {"direct": 1, "transposed": 2}
    y = conv.conv3x3_s1(x.requires_grad_(True), wt, b)
    assert conv.LAUNCHES == {"direct": 1, "transposed": 2}
    assert torch.equal(y, F.conv2d(x, wt, b, 1, 1))
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"
    conv.reset_launch_counts()
    assert conv.LAUNCHES == {"direct": 0, "transposed": 0}
    with pytest.raises(ValueError, match="3x3"):
        conv.conv3x3_s1(x, wt[:, :, :1, :1], b)


def _shading_out(net, xw, s, x_grad):
    out = net(xw, s, xw * s)
    grads = torch.autograd.grad(out, (xw, *net.parameters()), x_grad)
    return out.detach(), grads


def test_shading_net_routes_agree_f64(monkeypatch):
    torch.manual_seed(0)
    net = ShadingNetSPAA().double()
    g = torch.Generator().manual_seed(2)
    xw = torch.rand((2, 3, 16, 24), generator=g, dtype=torch.float64,
                    requires_grad=True)
    s = torch.rand((1, 3, 16, 24), generator=g, dtype=torch.float64)
    x_grad = torch.randn((2, 3, 16, 24), generator=g, dtype=torch.float64)
    plain, g_plain = _shading_out(net, xw, s, x_grad)
    conv.reset_launch_counts()
    runs = []
    for route in conv.ROUTES:
        with monkeypatch.context() as m:
            m.setattr(conv, "conv3x3_s1", _routed(route))
            runs.append(_shading_out(net, xw, s, x_grad))
    # nine routed layers a forward: skipConv1_2/1_4, conv3_s, conv4_s,
    # skipConv3, conv3, conv4, conv5, conv6
    assert conv.LAUNCHES == {"direct": 9, "transposed": 9}
    assert float(plain.abs().max()) > 0.0
    for out, grads in runs:
        assert float((out - plain).abs().max()) <= 1e-12
        for u, v in zip(grads, g_plain):
            assert float((u - v).abs().max()) <= 1e-12 * max(
                1.0, float(v.abs().max()))
    assert set(net.state_dict()) == set(ShadingNetSPAA().state_dict())


@pytest.mark.parametrize("route", conv.ROUTES)
def test_step_check_finds_the_projection_through_the_routed_node(
        route, monkeypatch):
    monkeypatch.setattr(conv, "conv3x3_s1", _routed(route))
    cam_hw, prj_hw = (48, 64), (32, 32)
    torch.manual_seed(1)
    model = PCNet(out_size=cam_hw).double().eval()
    for p in model.parameters():
        p.requires_grad_(False)
    g = torch.Generator().manual_seed(3)
    scene = torch.rand((1, *cam_hw, 3), generator=g, dtype=torch.float64)
    mask = torch.ones((*cam_hw, 1), dtype=torch.float64)
    trained = TrainedModel(model, mask, scene,
                           {"prj_im_sz": [prj_hw[1], prj_hw[0]]}, None,
                           "PCNet")
    prj = (torch.rand((2, *prj_hw, 3), generator=g, dtype=torch.float64)
           * 1.2 - 0.1).requires_grad_(True)
    x = torch.clamp(prj, 0.0, 1.0)
    cam = make_pcnet_fn(trained)(x)
    assert _leaf(x) is prj
    # the camera image's graph runs through the routed node down to prj
    seen, todo, names, reached = set(), [cam.grad_fn], set(), False
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        names.add(type(fn).__name__)
        reached |= getattr(fn, "variable", None) is prj
        todo.extend(f for f, _ in fn.next_functions)
    assert "Conv3x3S1Backward" in names and reached
    cot = torch.randn(cam.shape, generator=g, dtype=torch.float64)
    g_routed, = torch.autograd.grad(cam, prj, cot)
    monkeypatch.undo()
    g_plain, = torch.autograd.grad(make_pcnet_fn(trained)(
        torch.clamp(prj, 0.0, 1.0)), prj, cot)
    assert float((g_routed - g_plain).abs().max()) <= 1e-12
