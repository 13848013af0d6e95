"""The plain reference against the port, at small sizes on the CPU (the
tests may import the port; the reference may not), and the harness's own
pieces that need no card."""

import ast
import glob
import importlib
import json
import os
import random
import subprocess
import sys
from os.path import dirname, join
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark.drivers.scene import Scene
from benchmark.reference import classifiers as RC
from benchmark.reference import color as RCol
from benchmark.reference import inputs as I
from benchmark.reference import pcnet as RP
from benchmark.reference import spaa as RS
from benchmark.reference import ssim as RSsim
from benchmark.reference import train as RT

ROOT = H.ROOT
CONFIG = H.load_json(H.HERE, "configs", "spaa-resnet18.json")
SETUP = join(ROOT, CONFIG["setup_dir"])


def _ckpt(dtype=torch.float32):
    tree = I.read_flax_checkpoint(join(ROOT, CONFIG["pcnet_checkpoint"]))
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in I.flax_to_torch_names(tree).items()}


def test_readers_match_port():
    from spaa_tpu_torch.train.data import nayar_separation
    from spaa_tpu_torch.utils import log as L
    from spaa_tpu_torch.utils.imgproc_host import threshold_im
    from spaa_tpu_torch.utils.io import imread_dir, imread_u8
    from spaa_tpu_torch.weights import pcnet_state_dict
    for f in sorted(glob.glob(join(SETUP, "cam/raw/*/*.png"))):
        assert np.array_equal(I.read_png(f), imread_u8(f))
    mask_port, _, corners = threshold_im(
        nayar_separation(imread_dir(join(SETUP, "cam/raw/cb")), b=0.9)[0])
    sc = Scene(CONFIG)
    assert np.array_equal(sc.mask > 0, mask_port)
    assert np.allclose(sc.corners, corners)
    ckpt = join(ROOT, CONFIG["pcnet_checkpoint"])
    port = pcnet_state_dict(L.load_checkpoint(ckpt))
    mine = I.flax_to_torch_names(I.read_flax_checkpoint(ckpt))
    assert set(port) == set(mine)
    for k in port:
        assert np.array_equal(port[k].numpy(), mine[k])


def test_pcnet_matches_port():
    from spaa_tpu_torch.models.pcnet import PCNet
    p = _ckpt()
    model = PCNet(out_size=(240, 320))
    model.load_state_dict(p)
    model.eval()
    sc = Scene(CONFIG)
    scene, mask = sc.tensors("cpu")
    prj = torch.rand(2, 256, 256, 3, generator=torch.Generator()
                     .manual_seed(0))
    with torch.no_grad():
        g_port = model.warping_net.fine_grid()
        g_ref = RP.warp_grid(p, (240, 320))
        a = model(prj, scene, mask[..., None])
        b = RP.pcnet(p, g_ref, mask, scene, prj)
    assert float((g_port - g_ref).abs().max()) < 1e-5
    assert float((a - b).abs().max()) < 1e-4


@pytest.mark.parametrize("name,cls", [("resnet18", "ResNet18"),
                                      ("vgg16", "VGG16")])
def test_classifier_logits_match_port(name, cls):
    from spaa_tpu_torch.models import classifiers as C
    w = RC.draw_weights(name, 2 ** 31 + 3, "cpu")
    net = getattr(C, cls)()
    net.load_state_dict(w)
    net.eval()
    im = torch.rand(1, 240, 320, 3, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        a = C.make_logits_fn(net, (240, 240))(im)
        b = RC.logits(name, w, im, (240, 240))
    assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(
        b.abs().max()))


def test_weight_draw_is_seeded_and_scaled():
    a = RC.draw_weights("resnet18", 5, "cpu")
    b = RC.draw_weights("resnet18", 5, "cpu")
    c = RC.draw_weights("resnet18", 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert abs(float(a["conv1.weight"].std()) - (2 / 147) ** 0.5) < 0.01
    assert torch.all(a["bn1.running_var"] == 1)
    assert torch.all(a["bn1.weight"] == 1) and torch.all(a["fc.bias"] == 0)


def test_colour_matches_port():
    from spaa_tpu_torch.ops.color import ciede2000_diff, rgb2lab_diff
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(2, 20, 30, 3, generator=gen, dtype=torch.float64)
    y = torch.rand(1, 20, 30, 3, generator=gen, dtype=torch.float64)
    out = []
    for lab, de in ((rgb2lab_diff, ciede2000_diff),
                    (RCol.rgb2lab, RCol.ciede2000)):
        xx = x.clone().requires_grad_(True)
        d = de(lab(xx), lab(y).expand(2, -1, -1, -1))
        out.append((d.detach(), torch.autograd.grad(d.mean(), xx)[0]))
    (d0, g0), (d1, g1) = out
    # the port rounds the RGB->XYZ matrix to float32; the reference keeps
    # the published decimals
    assert float((d0 - d1).abs().max()) < 1e-5
    assert float((g0 - g1).abs().max()) < 1e-5 * float(g1.abs().max())


def test_ssim_matches_port():
    from spaa_tpu_torch.ops.ssim import ssim
    gen = torch.Generator().manual_seed(3)
    a = torch.rand(2, 30, 40, 3, generator=gen)
    b = torch.rand(2, 30, 40, 3, generator=gen)
    assert abs(float(ssim(a, b)) - float(RSsim.ssim(a, b))) < 1e-6


def test_spaa_step_matches_port_float64():
    """One iteration of the port's ``_spaa_body`` against the reference's
    step from the same state, both in float64: the crop is the classifier's
    input size, so no resampling makes max-pool ties."""
    from spaa_tpu_torch.attack.orchestrate import (make_attack_logits_fn,
                                                   make_pcnet_fn)
    from spaa_tpu_torch.models.classifiers import ResNet18
    from spaa_tpu_torch.models.pcnet import PCNet
    from spaa_tpu_torch.train.pipeline import TrainedModel
    S = importlib.import_module("spaa_tpu_torch.attack.spaa")
    dt64 = torch.float64
    h, w, hp = 224, 224, 32
    gen = torch.Generator().manual_seed(4)
    p = _ckpt(dt64)
    model = PCNet(out_size=(h, w)).to(dt64)
    model.load_state_dict(p)
    model.eval()
    for q in model.parameters():
        q.requires_grad_(False)
    scene = torch.rand(1, h, w, 3, generator=gen, dtype=dt64)
    mask = (torch.rand(h, w, generator=gen) > 0.3).to(dt64)
    trained = TrainedModel(model, mask[..., None], scene,
                           {"prj_im_sz": [hp, hp]}, None, "PCNet")
    cw = {k: v.to(dt64) for k, v in RC.draw_weights("resnet18", 9,
                                                    "cpu").items()}
    net = ResNet18().to(dt64)
    net.load_state_dict(cw)
    net.eval()
    for q in net.parameters():
        q.requires_grad_(False)
    pc = make_pcnet_fn(trained)
    lf = make_attack_logits_fn(SimpleNamespace(net=net), (h, w))
    b = 4
    prj = 0.5 + 0.1 * torch.rand(b, hp, hp, 3, generator=gen, dtype=dt64)
    with torch.no_grad():
        top = lf(pc(prj)).argmax(1)
    tgt = torch.tensor([3, 7, int(top[2]), int(top[3])])
    targeted = torch.tensor([True, True, False, True])
    wts = torch.tensor([[0, 1, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]],
                       dtype=dt64)
    d_thr = torch.tensor([5.0, 7.0, 9.0, 0.1], dtype=dt64)
    state = (prj, prj, scene.expand(b, -1, -1, -1).contiguous(),
             torch.full((b,), 1e6, dtype=dt64))
    out = S._spaa_body(pc, lf, scene, state, prj, tgt, targeted, wts, d_thr,
                       S.SpaaConfig(iters=1, camde_range=(1, 3)))
    grid = RP.warp_grid(p, (h, w))
    s = RS.step(lambda x: RP.pcnet(p, grid, mask, scene, x),
                lambda c: RC.logits("resnet18", cw, c, (h, w)), scene, prj,
                prj, tgt, targeted, wts, d_thr, b, RS.Hyper())
    nxt = torch.where(s["m"][:, None, None, None], s["next_col"],
                      s["next_adv"])
    assert bool(s["m"].any()) and not bool(s["m"].all())
    rel = ((out[0] - nxt).flatten(1).norm(dim=1)
           / (nxt - prj).flatten(1).norm(dim=1))
    assert float(rel.max()) < 1e-6


def test_perc_al_matches_port_float64():
    """Five iterations of the port's PerC-AL (projector variant, its
    ``_percal_body``) against the reference's steps and masks from the same
    states, and the whole reference loop against the port's, in float64:
    one targeted row already at its target (a best adversarial from the
    first step), one at another class, one untargeted."""
    from spaa_tpu_torch.attack import perc_al as P
    from spaa_tpu_torch.attack.orchestrate import make_attack_logits_fn
    from spaa_tpu_torch.models.classifiers import ResNet18
    from benchmark.reference import perc_al as RPA
    dt64 = torch.float64
    gen = torch.Generator().manual_seed(6)
    cw = {k: v.to(dt64) for k, v in RC.draw_weights("resnet18", 10,
                                                    "cpu").items()}
    net = ResNet18().to(dt64)
    net.load_state_dict(cw)
    net.eval()
    for q in net.parameters():
        q.requires_grad_(False)
    lf = make_attack_logits_fn(SimpleNamespace(net=net), (224, 224))

    def ref_lf(c):
        return RC.logits("resnet18", cw, c, (224, 224))

    scene = torch.rand(1, 224, 224, 3, generator=gen, dtype=dt64)
    inputs = scene.expand(3, -1, -1, -1).contiguous()
    with torch.no_grad():
        top = int(lf(scene).argmax(1)[0])
    labels = torch.tensor([top, (top + 500) % 1000, top])
    targeted = torch.tensor([True, True, False])
    d_thr = torch.full((3,), 0.5, dtype=dt64)
    hp = RPA.Hyper(iters=5, p_thresh=0.0)
    cfg = P.PercALConfig(max_iterations=5, confidence=hp.confidence,
                         p_thresh=hp.p_thresh)
    with torch.no_grad():
        lab = P.rgb2lab_diff(inputs)
        ref_lab = RCol.rgb2lab(inputs)
    state = (torch.zeros_like(inputs), torch.zeros(3, dtype=torch.bool),
             torch.full((3,), 1e5, dtype=dt64), inputs)
    masks = []
    for i in range(5):
        nxt = P._percal_body(lf, inputs, lab, labels, targeted, cfg, d_thr,
                             True, i, state)
        adv, col = RPA.step(ref_lf, inputs, ref_lab, state[0], labels,
                            targeted, i, hp)
        want = torch.where(state[1][:, None, None, None], col, adv)
        gap = (nxt[0] - want).flatten(1).norm(dim=1) / \
            (want - state[0]).flatten(1).norm(dim=1)
        # the port computes the step sizes in float32: 2.4e-8 of a step
        assert float(gap.max()) < 1e-6, i
        with torch.no_grad():
            x_round = RPA.quantize(inputs + nxt[0])
            succ, conf, pert = RPA.margins(ref_lf(x_round), nxt[0], labels,
                                           targeted, d_thr, hp)
        assert torch.equal(nxt[1], RPA.best_adv(succ, conf, pert, targeted))
        keep = RPA.adversarial(succ, targeted)[:, None, None, None]
        assert torch.equal(nxt[3], torch.where(keep, x_round, state[3]))
        masks.append(nxt[1])
        state = nxt
    masks = torch.stack(masks)
    assert bool(masks.any()) and not bool(masks.all())
    whole = RPA.attack(ref_lf, inputs, labels, targeted, d_thr, hp)
    assert float((whole - state[3]).abs().max()) < 1e-9


def test_compennet_pp_matches_port_float64():
    from spaa_tpu_torch.models.compen_net import CompenNetPlusplus
    from benchmark.drivers.percal_sweep import draw_compennet_pp
    from benchmark.reference import compennet as RCN
    dt64 = torch.float64
    gen = torch.Generator().manual_seed(7)
    p = {k: v.to(dt64) for k, v in draw_compennet_pp(gen, "cpu").items()}
    # a warp away from the identity, so the grid's every part counts
    p["warping_net.theta"] += 0.02 * torch.randn(
        p["warping_net.theta"].shape, generator=gen, dtype=dt64)
    p["warping_net.affine_mat"] += 0.05 * torch.randn(
        1, 2, 3, generator=gen, dtype=dt64)
    model = CompenNetPlusplus(out_size=(32, 40)).to(dt64)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        RCN.shapes()
    model.load_state_dict(p)
    model.eval()
    cam = torch.rand(2, 24, 36, 3, generator=gen, dtype=dt64)
    scene = torch.rand(1, 24, 36, 3, generator=gen, dtype=dt64)
    with torch.no_grad():
        a = model(cam, scene)
        b = RCN.compennet_pp(p, RP.warp_grid(p, (32, 40)), cam, scene)
    assert a.shape == (2, 32, 40, 3)
    assert 0.0 < float(b.max()) and float(b.min()) < 1.0
    assert float((a - b).abs().max()) < 1e-10


def test_train_steps_match_port_float64():
    """Three steps of the port's ``train_model`` (its loss, optimizer and
    schedule) against the reference's, in float64 at a small size."""
    from spaa_tpu_torch.models.pcnet import PCNet
    from spaa_tpu_torch.train.pipeline import make_pcnet_loss
    from spaa_tpu_torch.train.train import (get_model_train_cfg,
                                            make_pcnet_optimizer,
                                            train_model)
    from benchmark.drivers.pcnet_train import draw_pcnet_init
    dt64 = torch.float64
    h, w, hp, n, bs = 24, 32, 32, 12, 4
    gen = torch.Generator().manual_seed(5)
    shapes = {k: tuple(v.shape) for k, v in _ckpt().items()}
    corners = [[-0.7, -0.75], [0.7, -0.75], [0.7, 0.75], [-0.7, 0.75]]
    p0 = {k: v.to(dt64) for k, v in
          draw_pcnet_init(shapes, corners, gen, "cpu").items()}
    scene = torch.rand(1, h, w, 3, generator=gen, dtype=dt64)
    mask = (torch.rand(h, w, generator=gen) > 0.3).to(dt64)
    data = {"inputs": torch.randint(0, 256, (n, hp, hp, 3), generator=gen,
                                    dtype=torch.uint8),
            "targets": torch.randint(0, 256, (n, h, w, 3), generator=gen,
                                     dtype=torch.uint8)}
    plan = np.asarray(random.Random(0).sample(range(n), n),
                      np.int32).reshape(3, bs)
    model = PCNet(out_size=(h, w)).to(dt64)
    model.load_state_dict(p0)
    cfg = get_model_train_cfg(["PCNet"], single=True)
    cfg.max_iters, cfg.batch_size = 3, bs
    opt, sched = make_pcnet_optimizer(model, cfg)
    loss_fn = make_pcnet_loss(model, scene, mask[..., None])
    losses = []
    train_model(lambda x, y, i: loss_fn(x, y, i + 401), model, opt, sched,
                data, plan, cfg, "cpu", step_losses=losses)
    batches = [(data["inputs"][torch.as_tensor(i).long()].to(dt64) / 255,
                data["targets"][torch.as_tensor(i).long()].to(dt64) / 255)
               for i in plan]
    ref_losses, _, p_ref, _ = RT.train_steps(p0, mask, scene, batches)
    # the port draws the SSIM window in float32: 1e-7 of a loss
    assert np.allclose([a for a, _ in losses], ref_losses, rtol=1e-6)
    # Adam's first steps are near lr x sign(g), so an element whose
    # gradient is near zero moves by what the window's 1e-7 makes of it:
    # compare each leaf's change as a whole
    gaps = []
    for k, v in model.state_dict().items():
        d_ref = p_ref[k] - p0[k]
        gaps.append(float((v - p_ref[k]).norm() / d_ref.norm()))
    assert max(gaps) < 1e-2 and float(np.median(gaps)) < 1e-5


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_and_counters_import_nothing_of_the_program():
    here = H.HERE
    files = glob.glob(join(here, "reference", "**", "*.py"), recursive=True)
    files += glob.glob(join(here, "counts", "*.py"))
    bad = {"jax", "jaxlib", "flax", "spaa_tpu", "spaa_tpu_torch"}
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in bad, (f, mod)
    code = ("import sys, benchmark.reference.inputs, "
            "benchmark.reference.pcnet, benchmark.reference.classifiers, "
            "benchmark.reference.nets.resnet18, "
            "benchmark.reference.nets.vgg16, benchmark.reference.color, "
            "benchmark.reference.ssim, benchmark.reference.spaa, "
            "benchmark.reference.train, benchmark.reference.perc_al, "
            "benchmark.reference.compennet, benchmark.counts.flops, "
            "benchmark.counts.warp_bytes; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(ast.literal_eval(out.stdout.strip()))
    assert not loaded & bad


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spaa_tpu_torch_fake_x", sys)
    assert "spaa_tpu" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spaa_tpu.fake", sys)
    assert "spaa_tpu" in H.forbidden_modules()


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "resnet18-attack", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_reduce_trace_names_gaps_by_span():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "readback",
           "ts": 100.0, "dur": 50.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90.0,
           "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100.0,
           "dur": 5.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 130.0,
           "dur": 10.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 80.0,
           "dur": 80.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaFree",
           "ts": 108.0, "dur": 20.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 140.0, "dur": 2.0}]
    s = H.reduce_trace(ev)
    assert s["window_s"] == pytest.approx(80e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["kernels"]["k1"][0] == 2
    assert s["kernels"]["k1"][1] == pytest.approx(25e-6)
    gaps = sorted((n, round(t * 1e6, 6)) for n, t in s["gaps"])
    # the gap at 110-130 lies mostly inside the host's cudaFree
    assert gaps == [("outside_spans", 10.0), ("readback", 20.0),
                    ("readback:cudaFree", 20.0)]
    assert H.reduce_trace([])["busy_s"] == 0.0


def test_readers_give_nothing_without_data():
    spec = H.benchmark_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert H.metric_reader(m["name"])({"peaks": H.peaks()}) is None


def test_benchmark_json_finds_every_file():
    spec = H.benchmark_spec()
    for cell in spec["workloads"]:
        _, _, config, traffic, limits = H.cell_files(cell["name"])
        assert H.driver_class(traffic).kind in ("attack", "train")
        assert cell["config"] == config["name"]
        assert cell["traffic"] == traffic["name"]
        assert H.cell_metrics(spec, cell, "end_to_end")
        assert H.cell_metrics(spec, cell, "per_layer")
    for c in spec["configs"]:
        assert json.load(open(join(ROOT, c["file"])))["name"] == c["name"]
    assert os.path.isdir(join(ROOT, spec["paths"][0]))
    assert dirname(H.HERE) == ROOT


def test_stretches_start_and_stop_at_their_positions(monkeypatch):
    class Fake:
        def __init__(self):
            self.active = self.done = False
            self.calls = []

        def start(self):
            self.active = True
            self.calls.append("start")

        def stop(self):
            self.active, self.done = False, True
            self.calls.append("stop")
            self.summary = {"calls": self.calls}

    monkeypatch.setattr(H, "TraceWindow", Fake)
    st = H.Stretches({"steady": {"start": [0, 2], "stop": [0, 4]},
                      "boundary": {"start": [0, 5], "stop": [1, 1]}})
    for pos in ([0, i] for i in range(7)):
        st.at(pos)
    for pos in ([1, i] for i in range(3)):
        st.at(pos)
    st.at([0, 2])          # a position seen again starts nothing
    assert st.iters == 2 + 3
    assert st.summaries() == {"steady": {"calls": ["start", "stop"]},
                              "boundary": {"calls": ["start", "stop"]}}


def test_train_steps_resume_from_their_state(monkeypatch):
    """Steps resumed from the parameters and moments after some updates,
    with Adam's count and the schedule going on, give what one run does
    (here across the first group's milestone, moved to update 3)."""
    from benchmark.drivers.pcnet_train import draw_pcnet_init
    gen = torch.Generator().manual_seed(3)
    shapes = {k: tuple(v.shape) for k, v in _ckpt().items()}
    corners = [[-0.7, -0.75], [0.7, -0.75], [0.7, 0.75], [-0.7, 0.75]]
    dt64 = torch.float64
    p0 = {k: v.to(dt64) for k, v in
          draw_pcnet_init(shapes, corners, gen, "cpu").items()}
    h, w, hp = 24, 32, 32
    scene = torch.rand(1, h, w, 3, generator=gen, dtype=dt64)
    mask = (torch.rand(h, w, generator=gen) > 0.3).to(dt64)
    batches = [(torch.rand(2, hp, hp, 3, generator=gen, dtype=dt64),
                torch.rand(2, h, w, 3, generator=gen, dtype=dt64))
               for _ in range(4)]
    monkeypatch.setattr(RT, "GROUPS", tuple(
        (g, lr, 3 if g == "aff_tps" else ms, wd)
        for g, lr, ms, wd in RT.GROUPS))
    whole = RT.train_steps(p0, mask, scene, batches)
    head = RT.train_steps(p0, mask, scene, batches[:2])
    tail = RT.train_steps(head[2], mask, scene, batches[2:], head[3], t0=2,
                          k0=2)
    assert whole[0] == head[0] + tail[0]
    for k, v in whole[2].items():
        assert torch.equal(v, tail[2][k]), k
    cut = RT.train_steps(head[2], mask, scene, batches[2:], head[3], t0=2,
                         k0=0)
    assert not torch.equal(cut[2]["warping_net.theta"],
                           whole[2]["warping_net.theta"])


def test_leaf_under_pcnet_input_is_found_through_any_ops():
    from benchmark.drivers.spaa_sweep import _leaf
    prj = (torch.rand(2, 4, 4, 3) * 1.4 - 0.2).requires_grad_(True)
    assert _leaf(torch.clamp(prj, 0, 1)) is prj
    assert _leaf(torch.clamp(prj * 1.0, 0, 1).to(torch.float64)) is prj
    assert _leaf(torch.clamp(prj, 0, 1).detach()) is None
    other = torch.rand(2, 4, 4, 3, requires_grad=True)
    assert _leaf(torch.clamp(prj + other, 0, 1)) is None
