"""Port parity: CompenNet, CompenNet++ and their training against
``spaa_tpu``, at small sizes (camera 24x32, projector 32x32).

- CompenNet and CompenNet++ forwards, and CompenNet++'s ``simplify`` path
  (baked grid and surface features), float64 through the converted
  parameters, <=1e-8;
- ``init_weights`` draws ``spaa_tpu``'s ``model.init`` under key 0, jitted
  on the CPU as its pipeline runs it (``host_init``; keys
  and uniform draws exactly; under 2% of the normal draws differ, by <=3
  float32 ulps, as for PCNet);
- ``make_compennet_pp_optimizer``: its learning rates across two StepLR
  drops equal optax's schedule, and its Adam updates (weight decay
  included) equal ``spaa_tpu``'s optimizer, float64, <=1e-9 relative;
- the CompenNet pre-training loop (float data, batch 4) and the
  CompenNet++ loop (uint8 data, SSIM from iteration 0, an lr drop inside)
  through both training loops, float64, <=1e-9. ``spaa_tpu``'s SSIM
  window is patched to float64, as in test_torch_port_train.py;
- checkpoints, the CompenNet pre-training's included, read by the other
  package;
- ``threshold_im(compensation=True)`` equals ``spaa_tpu``'s cv2 version on
  the sim fixture's direct-light image, on seeded random images and on
  seeded random multi-blob masks.
"""

import importlib
import os
import random
from os.path import join

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization
from jax import enable_x64

from spaa_tpu.models import CompenNet as JaxCompenNet
from spaa_tpu.models import CompenNetPlusplus as JaxCompenNetPP
from spaa_tpu.models.warping_net import affine_from_corners as jax_affine
from spaa_tpu.train import train as JT
from spaa_tpu.utils import log as JL
from spaa_tpu.utils.config import DictConfig
from spaa_tpu.utils.imgproc_host import threshold_im as jax_threshold_im
from spaa_tpu.utils.jaxtools import host_init
from spaa_tpu_torch.models.compen_net import CompenNet, CompenNetPlusplus
from spaa_tpu_torch.train import pipeline as TP
from spaa_tpu_torch.train import train as TT
from spaa_tpu_torch.train.data import nayar_separation
from spaa_tpu_torch.utils import log as TL
from spaa_tpu_torch.utils.imgproc_host import threshold_im
from spaa_tpu_torch.utils.io import imread_dir
from spaa_tpu_torch.utils.seed import reset_rng_seeds
from spaa_tpu_torch.weights import (compennet_params, compennet_pp_params,
                                    compennet_pp_state_dict,
                                    compennet_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM, PRJ = (24, 32), (32, 32)
CORNERS = [[-0.75, -0.5], [0.5, -0.5], [0.5, 0.75], [-0.75, 0.75]]
jax_ssim_mod = importlib.import_module("spaa_tpu.ops.ssim")


@pytest.fixture
def ssim64(monkeypatch):
    orig = jax_ssim_mod._gaussian_1d
    monkeypatch.setattr(jax_ssim_mod, "_gaussian_1d",
                        lambda ws, s: orig(ws, s).astype(np.float64))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _jax_compennet():
    model = JaxCompenNet()
    return model, host_init(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *PRJ, 3)),
        jnp.zeros((1, *PRJ, 3)))["params"])


def _jax_compennet_pp(perturb=None):
    """spaa_tpu's CompenNet++ under key 0 with the inverse affine; with
    ``perturb`` (a numpy Generator) every leaf gets noise, so the grid
    refiner and TPS move the grid."""
    model = JaxCompenNetPP(out_size=PRJ)
    cam = jnp.zeros((1, *CAM, 3))
    p = host_init(lambda: model.init(jax.random.PRNGKey(0), cam,
                                     cam)["params"])
    p["warping_net"]["affine_mat"] = np.asarray(jax_affine(CORNERS, True))
    if perturb is not None:
        p = jax.tree.map(lambda a: (a + perturb.normal(0, 0.05, a.shape)
                                    * (np.abs(a).mean() + 1e-2)
                                    ).astype(np.float32), p)
    return model, p


def _assert_trees_close(got, want, atol, rtol=0.0):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    for k, v in flat_w.items():
        np.testing.assert_allclose(flat_g[k], v, rtol=rtol, atol=atol,
                                   err_msg=str(k))


# ----------------------------------------------------------------- forward
def test_compennet_forward_matches_f64():
    model, p = _jax_compennet()
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, *CAM, 3))
    s = rng.uniform(0, 1, (1, *CAM, 3))
    with enable_x64():
        want = np.asarray(jax.jit(model.apply)(
            {"params": _f64(p)}, jnp.asarray(x), jnp.asarray(s)))
    net = CompenNet()
    net.load_state_dict(compennet_state_dict(p, np.float64))
    net = net.double()
    got = net(torch.tensor(x), torch.tensor(s))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-8)
    sf = net.surface_features(torch.tensor(s))
    np.testing.assert_allclose(
        net(torch.tensor(x), None, surface_feats=sf).detach().numpy(), want,
        rtol=0, atol=1e-8)
    assert 0.0 < want.max() <= 1.0 and want.min() >= 0.0


def test_compennet_pp_forward_and_simplify_match_f64():
    model, p = _jax_compennet_pp(np.random.default_rng(2))
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, *CAM, 3))
    s = rng.uniform(0, 1, (1, *CAM, 3))
    with enable_x64():
        jp = {"params": _f64(p)}

        @jax.jit
        def run(jp, x, s):
            grid, sf = model.apply(jp, s, method=JaxCompenNetPP.simplify)
            return (model.apply(jp, x, s), grid, sf,
                    model.apply(jp, x, s, fine_grid=grid, surface_feats=sf))

        want, grid_j, sf_j, want_cached = jax.tree.map(
            np.asarray, run(jp, jnp.asarray(x), jnp.asarray(s)))
    net = CompenNetPlusplus(PRJ)
    net.load_state_dict(compennet_pp_state_dict(p, np.float64))
    net = net.double().requires_grad_(False)
    np.testing.assert_allclose(net(torch.tensor(x), torch.tensor(s)).numpy(),
                               want, rtol=0, atol=1e-8)
    grid, sf = net.simplify(torch.tensor(s))
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_j), rtol=0,
                               atol=1e-8)
    for a, b in zip(sf, sf_j):           # NCHW here, NHWC in spaa_tpu
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=0, atol=1e-8)
    got = net(torch.tensor(x), torch.tensor(s), fine_grid=grid,
              surface_feats=sf)
    np.testing.assert_allclose(got.numpy(), want_cached, rtol=0, atol=1e-8)
    np.testing.assert_allclose(want_cached, want, rtol=0, atol=1e-8)
    assert want.shape == (2, *PRJ, 3) and np.abs(np.asarray(grid_j)).max() \
        <= 1.0


# -------------------------------------------------------------------- init
def _assert_draws_equal(got, want):
    """Keys and uniform draws exactly; the normal draws to 3 float32 ulps
    on under 2% of the values (XLA's ``log1p`` inside ``erf_inv``)."""
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    bits = [(flat_w[k].view(np.int32).astype(np.int64),
             flat_g[k].view(np.int32).astype(np.int64)) for k in flat_w]
    assert sum(int((a != b).sum()) for a, b in bits) \
        <= 0.02 * sum(a.size for a, _ in bits)
    assert max(int(np.abs(a - b).max()) for a, b in bits) <= 3
    for k, w in flat_w.items():
        name = jax.tree_util.keystr(k)
        if "bias" in name or "transConv" in name or "tconv" in name \
                or "affine_mat" in name or "theta" in name:
            np.testing.assert_array_equal(flat_g[k], w, err_msg=name)


def test_init_draws_spaa_tpu_weights():
    key = reset_rng_seeds(0)
    _, want = _jax_compennet()
    _assert_draws_equal(compennet_params(CompenNet().init_weights(key)
                                         .state_dict()), want)
    model = JaxCompenNetPP(out_size=PRJ)
    cam = jnp.zeros((1, *CAM, 3))
    want = host_init(lambda: model.init(jax.random.PRNGKey(0), cam,
                                        cam)["params"])
    got = CompenNetPlusplus(PRJ).init_weights(key)
    _assert_draws_equal(compennet_pp_params(got.state_dict()), want)


# --------------------------------------------------------------- optimizer
def _cfg(**kw):
    return DictConfig({**dict(lr=1e-3, lr_drop_ratio=0.2, lr_drop_rate=5,
                              max_iters=12, l2_reg=1e-4), **kw})


def test_optimizer_matches_optax_across_steplr_drops():
    n = 12
    jparams = {"warping_net": {"affine_mat": np.zeros(2),
                               "grid_refine_net": {"w": np.full(2, 0.3)}},
               "compen_net": {"w": np.full(2, 0.5)}}
    with enable_x64():
        tx = JT.make_compennet_pp_optimizer(_cfg())
        p = _f64(jparams)

        @jax.jit
        def run(p, state):
            def body(carry, _):
                p, s = carry
                u, s = tx.update(jax.tree.map(jnp.ones_like, p), s, p)
                return (optax.apply_updates(p, u), s), u
            return jax.lax.scan(body, (p, state), None, length=n)[1]

        upd = _np_tree(run(p, tx.init(p)))
        sched = optax.piecewise_constant_schedule(1e-3, {5: 0.2, 10: 0.2})
        want_lr = [float(sched(k)) for k in range(n)]

    net = torch.nn.Module()
    net.warping_net = torch.nn.Module()
    net.warping_net.affine_mat = torch.nn.Parameter(torch.zeros(2).double())
    net.warping_net.grid_refine_net = torch.nn.Module()
    net.warping_net.grid_refine_net.w = torch.nn.Parameter(
        torch.full((2,), 0.3).double())
    net.compen_net = torch.nn.Module()
    net.compen_net.w = torch.nn.Parameter(torch.full((2,), 0.5).double())
    opt, sched_t = TT.make_compennet_pp_optimizer(net, _cfg())
    names = ["warping_net.affine_mat", "warping_net.grid_refine_net.w",
             "compen_net.w"]
    params = dict(net.named_parameters())
    got = {nm: np.zeros((n, 2)) for nm in names}
    lrs = []
    for k in range(n):
        lrs.append(opt.param_groups[0]["lr"])
        before = {nm: params[nm].detach().clone() for nm in names}
        for q in net.parameters():
            q.grad = torch.ones_like(q)
        opt.step()
        sched_t.step()
        for nm in names:
            got[nm][k] = (params[nm].detach() - before[nm]).numpy()
    np.testing.assert_allclose(lrs, want_lr, rtol=1e-12)
    assert lrs[4] == 1e-3 and lrs[5] < lrs[4] and lrs[10] < lrs[9]
    for nm, w in zip(names, (upd["warping_net"]["affine_mat"],
                             upd["warping_net"]["grid_refine_net"]["w"],
                             upd["compen_net"]["w"])):
        np.testing.assert_allclose(got[nm], w, rtol=1e-9, atol=1e-15,
                                   err_msg=nm)


# ----------------------------------------------------------- train loops
def _both_loops(jmodel, jparams, tnet, to_params, inputs, targets, scene,
                iters, batch, cfg_kw, loss="l1+ssim"):
    """Train the same model with both loops (both optimizers, both loss
    functions) on the same data and minibatch plan; returns the two param
    trees. ``spaa_tpu`` gets float64 arrays of the values the port's loop
    feeds (uint8 -> float32 -> float64)."""
    idx = JT.sample_batch_indices(inputs.shape[0], batch, iters,
                                  random.Random(7))
    cfg = _cfg(valid_rate=2, **cfg_kw)
    cfg.max_iters = iters
    arrays = dict(inputs=inputs, targets=targets)
    f64_arrays = {k: (v.astype(np.float32) / np.float32(255)).astype(
        np.float64) if v.dtype == np.uint8 else v.astype(np.float64)
        for k, v in arrays.items()}
    with enable_x64():
        def jloss(p, x, y, itr):
            del itr
            infer = jmodel.apply({"params": p}, x, jnp.asarray(scene))
            return JT.compute_loss(infer, y, loss)

        p_j, *_ = JT.train_model_scan(jloss, _f64(jparams),
                                      JT.make_compennet_pp_optimizer(cfg),
                                      f64_arrays, idx, cfg, use_scan=False)
        p_j = _np_tree(p_j)
    opt, sched = TT.make_compennet_pp_optimizer(tnet, cfg)
    TT.train_model(TP.make_compennet_loss(tnet, torch.tensor(scene), loss),
                   tnet, opt, sched, arrays, idx, cfg, "cpu")
    return p_j, to_params(tnet.state_dict())


def test_compennet_pretraining_loop_matches_f64(ssim64):
    """The loop of ``init_compennet``: float images (|prj - 0.3 s| ->
    prj), l1+ssim, no validation."""
    jmodel, p = _jax_compennet()
    rng = np.random.default_rng(4)
    prj = (rng.integers(0, 256, (6, *PRJ, 3)) / 255.0).astype(np.float32)
    scene = (rng.integers(0, 256, (1, *PRJ, 3)) / 255.0).astype(np.float32)
    cam = np.abs(prj - 0.3 * scene)
    net = CompenNet()
    net.load_state_dict(compennet_state_dict(p, np.float64))
    p_j, p_t = _both_loops(jmodel, p, net.double(), compennet_params, cam,
                           prj, scene.astype(np.float64), 4, 4,
                           dict(lr_drop_rate=800))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(p_j), jax.tree.leaves(p)))
    assert moved > 1e-4
    _assert_trees_close(p_t, p_j, atol=1e-9)


def test_compennet_pp_loop_matches_f64(ssim64):
    """The loop of ``train_eval_compennet_pp``: uint8 camera -> projector
    pairs, SSIM from iteration 0, an lr drop after 2 updates, every
    parameter (affine and TPS included) in the one Adam."""
    jmodel, p = _jax_compennet_pp(np.random.default_rng(5))
    rng = np.random.default_rng(6)
    cam = rng.integers(0, 256, (6, *CAM, 3), dtype=np.uint8)
    prj = rng.integers(0, 256, (6, *PRJ, 3), dtype=np.uint8)
    scene = rng.uniform(0.05, 0.95, (1, *CAM, 3))
    net = CompenNetPlusplus(PRJ)
    net.load_state_dict(compennet_pp_state_dict(p, np.float64))
    p_j, p_t = _both_loops(jmodel, p, net.double(), compennet_pp_params,
                           cam, prj, scene, 4, 3, dict(lr_drop_rate=2))
    assert np.abs(p_j["warping_net"]["affine_mat"]
                  - p["warping_net"]["affine_mat"]).max() > 1e-4
    _assert_trees_close(p_t, p_j, atol=1e-9)


# -------------------------------------------------------------- checkpoints
def test_checkpoints_read_by_the_other_package(tmp_path):
    net = CompenNetPlusplus(PRJ).init_weights(reset_rng_seeds(4))
    tree = compennet_pp_params(net.state_dict())
    path = TL.save_checkpoint(str(tmp_path / "port"), tree, "run")
    data = open(path, "rb").read()
    assert data == serialization.to_bytes(tree)
    _, want = _jax_compennet_pp()
    template = jax.tree.map(np.zeros_like, want)
    restored = JL.load_checkpoint(path, template)        # spaa_tpu reads it
    assert open(JL.save_checkpoint(str(tmp_path / "jax"), restored, "run"),
                "rb").read() == data
    # the CompenNet pre-training's checkpoint, both ways
    jmodel, jp = _jax_compennet()
    jpath = JL.save_checkpoint(str(tmp_path / "jax"), jp, TP.INIT_CKPT_NAME)
    cnet = CompenNet()
    cnet.load_state_dict(compennet_state_dict(TL.load_checkpoint(jpath)))
    _assert_trees_close(compennet_params(cnet.state_dict()), jp, atol=0)
    tpath = TL.save_checkpoint(str(tmp_path / "port"),
                               compennet_params(cnet.state_dict()),
                               TP.INIT_CKPT_NAME)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    back = JL.load_checkpoint(tpath, jax.tree.map(np.zeros_like, jp))
    _assert_trees_close(_np_tree(back), jp, atol=0)
    # the port's pre-training finds its cached checkpoint and loads it
    data_root = tmp_path / "data"
    data_root.mkdir()
    os.makedirs(tmp_path / "checkpoint")
    os.link(tpath, tmp_path / "checkpoint" / (TP.INIT_CKPT_NAME + ".flax"))
    loaded = TP.init_compennet(str(data_root), DictConfig({}), "cpu")
    for k, v in cnet.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# ------------------------------------------------------ compensation mask
def _same_threshold(im):
    want = jax_threshold_im(im, compensation=True)
    got = threshold_im(im, compensation=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    return got


def test_threshold_im_compensation_matches_spaa_tpu():
    direct, _ = nayar_separation(imread_dir(join(
        REPO, "spaa_tpu_torch", "assets", "sim_setup", "cam", "raw", "cb")))
    mask, roi, _ = _same_threshold(direct)
    assert roi.sum() > 1000 and (mask & ~roi).any()   # more than one blob
    rng = np.random.default_rng(8)
    for t in range(40):
        h, w = (int(v) for v in rng.integers(12, 48, 2))
        yy, xx = np.ogrid[:h, :w]
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(1, 6))):
            cy, cx, r = rng.integers(0, h), rng.integers(0, w), \
                rng.integers(1, 7)
            m |= (yy - cy) ** 2 + rng.uniform(0.3, 2) * (xx - cx) ** 2 \
                <= r * r
        m &= rng.random((h, w)) > 0.1 * (t % 3)    # holes and specks
        if m.any():
            _same_threshold(m)
        # a float image whose 4-class Otsu leaves several bright blobs
        _same_threshold(np.clip(m[..., None] * rng.uniform(0.6, 1, (h, w, 3))
                                + rng.uniform(0, 0.3, (h, w, 3)), 0, 1)
                        .astype(np.float32))
