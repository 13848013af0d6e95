"""Port parity: the training runtime against ``spaa_tpu``.

PCNet carries the committed checkpoint's weights (float64) at a small size
(camera 24x32, projector 32x32). ``spaa_tpu``'s SSIM window is a float32
array that float64 convolutions refuse, so its float64 runs here use the
same window values as float64 (a test-side patch of
``spaa_tpu.ops.ssim._gaussian_1d``; the port casts the same float32
values).

- SSIM (map, masked, per sample) and ``calc_img_dists`` / per-sample
  metrics, float64, <=1e-6;
- ``compute_loss`` and its gradient through PCNet, with the curriculum
  weight off and on and the huber term, float64, <=1e-8;
- the three groups' learning rates at iterations 0, 99, 100, 1199, 1200,
  1799, 1800 equal optax's schedules (to float32 rounding: optax scales in
  float32), and 1801 Adam updates on a constant
  gradient equal ``spaa_tpu``'s optimizer (<=1e-9 relative);
- ``sample_batch_indices`` draws ``spaa_tpu``'s minibatches;
- one training step under SGD through both training loops from the same
  parameters (the port's on uint8 data: gather, then cast), float64,
  <=1e-12; six Adam steps
  with the curriculum, float64, <=1e-9 (float64 leaves no near-zero
  gradient whose sign a rounding difference could flip);
- the validation evaluator (chunking by ``min(chunk_sz, n)`` chunks,
  weighted by share) against ``spaa_tpu``'s, float32, <=1e-5;
- PCNet's seeded init draws ``spaa_tpu``'s initial weights (keys and
  uniform draws exactly, normal draws to float32 ulps);
- checkpoints both ways: the port's ``.flax`` bytes equal
  ``flax.serialization.to_bytes`` and ``spaa_tpu``'s own writer, and
  ``spaa_tpu.utils.log.load_checkpoint`` reads them; the port reads
  ``spaa_tpu``'s;
- resume: a run killed after one segment resumes to the uninterrupted
  trajectory bitwise; a stale or foreign snapshot is discarded;
- the metrics log: the same CSV bytes as ``spaa_tpu``'s pandas writer.
"""

import importlib
import os
import random
import zipfile
from os.path import join

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization
from jax import enable_x64

from spaa_tpu.models import PCNet as JaxPCNet
from spaa_tpu.ops import metrics as JM
from spaa_tpu.train import train as JT
from spaa_tpu.utils import log as JL
from spaa_tpu.utils.config import DictConfig
from spaa_tpu_torch.models.pcnet import PCNet
from spaa_tpu_torch.ops import metrics as TM
from spaa_tpu_torch.ops.ssim import ssim as port_ssim
from spaa_tpu_torch.ops.ssim import ssim_map as port_ssim_map
from spaa_tpu_torch.train import train as TT
from spaa_tpu_torch.utils import log as TL
from spaa_tpu_torch.utils.seed import reset_rng_seeds
from spaa_tpu_torch.weights import pcnet_params, pcnet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = join(REPO, "checkpoint",
            "sim_setup_PCNet_l1+ssim_500_24_2000_0.001_0.2_800_0.0001.flax")
CAM, PRJ = (24, 32), (32, 32)
# the module (``spaa_tpu.ops`` re-exports its ``ssim`` function by that name)
jax_ssim_mod = importlib.import_module("spaa_tpu.ops.ssim")


@pytest.fixture
def ssim64(monkeypatch):
    orig = jax_ssim_mod._gaussian_1d
    monkeypatch.setattr(jax_ssim_mod, "_gaussian_1d",
                        lambda ws, s: orig(ws, s).astype(np.float64))


@pytest.fixture(scope="module")
def ckpt_params():
    with open(CKPT, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _port_pcnet(params, dtype=torch.float64):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    net = PCNet(out_size=CAM)
    net.load_state_dict(pcnet_state_dict(params, npdt))
    return net.to(dtype)


def _scene_mask(rng):
    scene = rng.uniform(0.05, 0.95, (1, *CAM, 3))
    mask = np.ones((*CAM, 1))
    mask[:3], mask[:, -4:] = 0.0, 0.0
    return scene, mask


def _u8_data(rng, n):
    prj = rng.integers(0, 256, (n, *PRJ, 3), dtype=np.uint8)
    cam = rng.integers(0, 256, (n, *CAM, 3), dtype=np.uint8)
    return prj, cam


# ----------------------------------------------------------------- metrics
def test_ssim_and_metrics_match_f64(ssim64):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 20, 27, 3))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    mask = (rng.random((3, 20, 27, 3)) > 0.3).astype(np.float64)
    wts = rng.random((3, 20, 27, 3))
    ta, tb = torch.tensor(a), torch.tensor(b)
    with enable_x64():
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        pairs = [
            (jax_ssim_mod.ssim_map(ja, jb), port_ssim_map(ta, tb)),
            (jax_ssim_mod.ssim(ja, jb), port_ssim(ta, tb)),
            (jax_ssim_mod.ssim(ja, jb, size_average=False),
             port_ssim(ta, tb, size_average=False)),
            (jax_ssim_mod.ssim(ja, jb, mask=jnp.asarray(mask),
                               weights=jnp.asarray(wts)),
             port_ssim(ta, tb, mask=torch.tensor(mask),
                       weights=torch.tensor(wts))),
            (jax_ssim_mod.ssim(ja, jb, size_average=False,
                               mask=jnp.asarray(mask)),
             port_ssim(ta, tb, size_average=False, mask=torch.tensor(mask)))]
        want_d = JM.calc_img_dists(ja, jb)
        want_ps = [np.asarray(v) for v in JM.per_sample_img_dists(ja, jb)]
        want_sl = JM.dists_from_per_sample(want_ps, slice(1, 3))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(TM.calc_img_dists(ta, tb), want_d, rtol=0,
                               atol=1e-6)
    got_ps = TM.per_sample_img_dists(ta, tb)
    for want, got in zip(want_ps, got_ps):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(TM.dists_from_per_sample(got_ps, slice(1, 3)),
                               want_sl, rtol=0, atol=1e-6)
    singles = [(TM.psnr, JM.psnr), (TM.rmse, JM.rmse), (TM.ssim, JM.ssim),
               (TM.l2_norm, JM.l2_norm), (TM.linf_norm, JM.linf_norm),
               (TM.deltaE, JM.deltaE)]
    with enable_x64():
        for f_t, f_j in singles:
            assert abs(f_t(ta, tb) - f_j(jnp.asarray(a), jnp.asarray(b))) \
                <= 1e-6, f_t.__name__


# ------------------------------------------------------ loss and gradient
@pytest.mark.parametrize("option,weight", [("l1+ssim", 0.0),
                                           ("l1+ssim", 1.0),
                                           ("l1+l2+ssim+huber", None)])
def test_loss_and_gradient_through_pcnet_f64(ssim64, ckpt_params, option,
                                             weight):
    rng = np.random.default_rng(1)
    scene, mask = _scene_mask(rng)
    prj = rng.uniform(0, 1, (2, *PRJ, 3))
    gt = rng.uniform(0, 1, (2, *CAM, 3))
    with enable_x64():
        model = JaxPCNet(out_size=CAM)

        def jloss(p):
            infer = model.apply({"params": p}, jnp.asarray(prj),
                                jnp.asarray(scene), jnp.asarray(mask))
            w = None if weight is None else jnp.asarray(weight)
            return JT.compute_loss(infer, jnp.asarray(gt), option,
                                   ssim_weight=w)

        (loss_j, l2_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
            _f64(ckpt_params))
        g_j = jax.tree.map(np.asarray, g_j)
    net = _port_pcnet(ckpt_params)
    infer = net(torch.tensor(prj), torch.tensor(scene), torch.tensor(mask))
    loss_t, l2_t = TT.compute_loss(infer, torch.tensor(gt), option,
                                   ssim_weight=weight)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-8
    assert abs(l2_t.item() - float(l2_j)) <= 1e-8
    g_t = pcnet_params({k: p.grad for k, p in net.named_parameters()})
    flat_j = dict(jax.tree_util.tree_leaves_with_path(g_j))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(g_t))
    assert sorted(map(str, flat_j)) == sorted(map(str, flat_t))
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_t[k], v, rtol=0, atol=1e-8,
                                   err_msg=str(k))


# ------------------------------------------------------------- optimizer
class _Groups(torch.nn.Module):
    """One parameter in each of PCNet's three optimizer groups, named as
    PCNet's are."""

    def __init__(self):
        super().__init__()
        self.warping_net = torch.nn.Module()
        self.warping_net.affine_mat = torch.nn.Parameter(torch.zeros(2))
        self.warping_net.grid_refine_net = torch.nn.Module()
        self.warping_net.grid_refine_net.w = torch.nn.Parameter(
            torch.zeros(2))
        self.shading_net = torch.nn.Module()
        self.shading_net.w = torch.nn.Parameter(torch.full((2,), 0.5))


def _cfg():
    return DictConfig(dict(lr_drop_ratio=0.2, l2_reg=1e-4, max_iters=2000))


def test_group_learning_rates_match_optax_schedules():
    opt, sched = TT.make_pcnet_optimizer(_Groups().double(), _cfg())
    checks = (0, 99, 100, 1199, 1200, 1799, 1800)
    seen = {}
    for k in range(max(checks) + 1):
        if k in checks:
            seen[k] = [g["lr"] for g in opt.param_groups]
        opt.step()            # no gradients: a no-op that keeps the order
        sched.step()
    for gi, (_, lr, milestone) in enumerate(TT.PCNET_GROUPS):
        s = optax.piecewise_constant_schedule(lr, {milestone: 0.2})
        for k in checks:
            # optax scales in float32, the port in float64
            np.testing.assert_allclose(seen[k][gi], float(s(k)), rtol=2e-7,
                                       err_msg=str((gi, k)))
            assert (seen[k][gi] < lr) == (k >= milestone)


def test_adam_updates_match_spaa_tpu_optimizer():
    n = 1801
    jparams = {"warping_net": {"affine_mat": np.zeros(2),
                               "grid_refine_net": {"w": np.zeros(2)}},
               "shading_net": {"w": np.full(2, 0.5)}}
    with enable_x64():
        tx = JT.make_pcnet_optimizer(_cfg())
        p = _f64(jparams)
        state = tx.init(p)

        @jax.jit
        def run(p, state):
            def body(carry, _):
                p, s = carry
                g = jax.tree.map(jnp.ones_like, p)
                u, s = tx.update(g, s, p)
                return (optax.apply_updates(p, u), s), u
            return jax.lax.scan(body, (p, state), None, length=n)[1]

        upd = jax.tree.map(np.asarray, run(p, state))
    net = _Groups().double()
    opt, sched = TT.make_pcnet_optimizer(net, _cfg())
    names = ["warping_net.affine_mat", "warping_net.grid_refine_net.w",
             "shading_net.w"]
    want = [upd["warping_net"]["affine_mat"],
            upd["warping_net"]["grid_refine_net"]["w"],
            upd["shading_net"]["w"]]
    got = [np.zeros((n, 2)) for _ in names]
    params = dict(net.named_parameters())
    for k in range(n):
        before = [params[nm].detach().clone() for nm in names]
        for q in net.parameters():
            q.grad = torch.ones_like(q)
        opt.step()
        sched.step()
        for i, nm in enumerate(names):
            got[i][k] = (params[nm].detach() - before[i]).numpy()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-15)


def test_sample_batch_indices_match():
    reset_rng_seeds(123)
    got = TT.sample_batch_indices(40, 7, 30)
    random.seed(123)
    want = JT.sample_batch_indices(40, 7, 30)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    r1, r2 = random.Random(5), random.Random(5)
    assert np.array_equal(TT.sample_batch_indices(9, 9, 4, r1),
                          JT.sample_batch_indices(9, 9, 4, r2))


# ----------------------------------------------------------- train loops
def _both_loops(ckpt_params, tx, make_opt, iters, valid_rate, rng_seed=2,
                curriculum=0):
    """Train the same PCNet with both loops on the same uint8 data and
    minibatch plan; returns (spaa_tpu params, port params as a tree)."""
    rng = np.random.default_rng(rng_seed)
    scene, mask = _scene_mask(rng)
    prj, cam = _u8_data(rng, 6)
    idx = JT.sample_batch_indices(6, 3, iters, random.Random(7))
    cfg = DictConfig(dict(max_iters=iters, valid_rate=valid_rate))
    arrays = dict(inputs=prj, targets=cam)
    # spaa_tpu's loop casts uint8 to float32, which its float64 SSIM
    # refuses; it gets the same values as float64, the port the uint8
    # data, which its loop casts to float32 and then to the model's type
    f64_arrays = {k: (v.astype(np.float32) / np.float32(255)).astype(
        np.float64) for k, v in arrays.items()}
    with enable_x64():
        model = JaxPCNet(out_size=CAM)

        def jloss(p, x, y, itr):
            infer = model.apply({"params": p}, x, jnp.asarray(scene),
                                jnp.asarray(mask))
            w = (itr > curriculum).astype(jnp.float64)
            return JT.compute_loss(infer, y, "l1+ssim", ssim_weight=w)

        p_j, *_ = JT.train_model_scan(jloss, _f64(ckpt_params), tx,
                                      f64_arrays, idx, cfg, use_scan=False)
        p_j = jax.tree.map(np.asarray, p_j)
    net = _port_pcnet(ckpt_params)
    s_t, m_t = torch.tensor(scene), torch.tensor(mask)

    def tloss(x, y, itr):
        return TT.compute_loss(net(x, s_t, m_t), y, "l1+ssim",
                               ssim_weight=1.0 if itr > curriculum else 0.0)

    opt, sched = make_opt(net)
    TT.train_model(tloss, net, opt, sched, arrays, idx, cfg, "cpu")
    return p_j, pcnet_params(net.state_dict())


def _assert_trees_close(got, want, atol, rtol=0.0):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    for k, v in flat_w.items():
        np.testing.assert_allclose(flat_g[k], v, rtol=rtol, atol=atol,
                                   err_msg=str(k))


def test_one_sgd_step_matches_f64(ssim64, ckpt_params):
    def make_opt(net):
        opt = torch.optim.SGD(net.parameters(), lr=0.5)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0)

    p_j, p_t = _both_loops(ckpt_params, optax.sgd(0.5), make_opt, 1, 1)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(p_j), jax.tree.leaves(_f64(ckpt_params))))
    assert moved > 1e-4          # the step is not a no-op
    _assert_trees_close(p_t, p_j, atol=1e-12)


def test_adam_steps_with_curriculum_match_f64(ssim64, ckpt_params):
    cfg = DictConfig(dict(lr_drop_ratio=0.2, l2_reg=1e-4))
    p_j, p_t = _both_loops(ckpt_params, JT.make_pcnet_optimizer(cfg),
                           lambda net: TT.make_pcnet_optimizer(net, cfg), 6,
                           3, curriculum=2)
    _assert_trees_close(p_t, p_j, atol=1e-9)


def test_evaluator_matches_spaa_tpu(ckpt_params):
    rng = np.random.default_rng(3)
    scene, mask = _scene_mask(rng)
    prj, cam = _u8_data(rng, 25)
    scene32, mask32 = scene.astype(np.float32), mask.astype(np.float32)
    model = JaxPCNet(out_size=CAM)
    jev = JT.make_evaluator(
        lambda p, x, s: model.apply({"params": p}, x, s, jnp.asarray(mask32)),
        prj, cam, scene32, fused=False)
    net = _port_pcnet(ckpt_params, torch.float32).eval()
    s_t, m_t = torch.tensor(scene32), torch.tensor(mask32)
    tev = TT.make_evaluator(lambda x: net(x, s_t, m_t), prj, cam, "cpu")
    for images in (False, True):
        want = jev(ckpt_params, return_images=images)
        got = tev(return_images=images)
        np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-5)
        if images:
            assert got[3].shape == (25, *CAM, 3)
            np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)


# -------------------------------------------------------------------- init
@pytest.mark.parametrize("seed", [123, 0])
def test_pcnet_init_draws_spaa_tpu_weights(seed):
    """``_build_pcnet`` under ``reset_rng_seeds(seed)`` draws ``spaa_tpu``'s
    initial weights for the same seed: keys and uniform draws exactly, the
    normal draws within 1e-6 of each leaf's largest value (XLA's
    ``log1p`` inside ``erf_inv``), at least 95% of them exactly."""
    from spaa_tpu.train.pipeline import _build_pcnet as jax_build
    from spaa_tpu.utils.seed import reset_rng_seeds as jax_seeds
    from spaa_tpu_torch.train.pipeline import _build_pcnet
    from spaa_tpu_torch.utils import threefry

    assert np.array_equal(reset_rng_seeds(seed),
                          jax.random.key_data(jax.random.PRNGKey(seed)))
    key = jax.random.PRNGKey(seed)
    for data in (0, 7, 2**31 + 5):
        assert np.array_equal(threefry.fold_in(reset_rng_seeds(seed), data),
                              jax.random.key_data(jax.random.fold_in(key,
                                                                     data)))
    corners = [[-0.75, -0.5], [0.5, -0.5], [0.5, 0.75], [-0.75, 0.75]]
    want = jax.tree.map(np.asarray,
                        jax_build("PCNet", CAM, corners, jax_seeds(seed))[1])
    got = pcnet_params(_build_pcnet("PCNet", CAM, corners,
                                    reset_rng_seeds(seed)).state_dict())
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    # over the whole tree (its shapes do not depend on the image size):
    # under 2% of the values differ, none by more than 3 float32 ulps
    bits = [(flat_w[k].view(np.int32).astype(np.int64),
             flat_g[k].view(np.int32).astype(np.int64)) for k in flat_w]
    assert sum(int((a != b).sum()) for a, b in bits) \
        <= 0.02 * sum(a.size for a, _ in bits)
    assert max(int(np.abs(a - b).max()) for a, b in bits) <= 3
    for k, w in flat_w.items():
        name, g = jax.tree_util.keystr(k), flat_g[k]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)
        assert (g == w).mean() >= 0.95, name
        uniform = "bias" in name or any(
            f"['{m}']" in name
            for m in ("transConv1", "transConv2", "tconv1", "tconv2"))
        if uniform:
            np.testing.assert_array_equal(g, w, err_msg=name)


# -------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_both_ways(tmp_path, ckpt_params):
    net = PCNet(out_size=CAM).init_weights(reset_rng_seeds(4))
    tree = pcnet_params(net.state_dict())
    path = TL.save_checkpoint(str(tmp_path / "port"), tree, "run")
    data = open(path, "rb").read()
    assert data == serialization.to_bytes(tree)
    template = jax.tree.map(np.zeros_like, ckpt_params)
    restored = JL.load_checkpoint(path, template)        # spaa_tpu reads it
    jpath = JL.save_checkpoint(str(tmp_path / "jax"), restored, "run")
    assert open(jpath, "rb").read() == data
    back = PCNet(out_size=CAM)
    back.load_state_dict(pcnet_state_dict(TL.load_checkpoint(path)))
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # spaa_tpu's file -> the port -> the same tree
    port_tree = pcnet_params(_port_pcnet(ckpt_params,
                                         torch.float32).state_dict())
    _assert_trees_close(port_tree, ckpt_params, atol=0)
    assert TL.msgpack_pack(port_tree) == open(CKPT, "rb").read()


# ------------------------------------------------------------------ resume
def _toy_run(tmp_path, resume, kill_at=None, max_iters=8):
    torch.manual_seed(0)
    net = PCNet(out_size=CAM).init_weights(reset_rng_seeds(5))
    rng = np.random.default_rng(6)
    scene, mask = (torch.tensor(a, dtype=torch.float32)
                   for a in _scene_mask(rng))
    prj, cam = _u8_data(rng, 6)
    idx = TT.sample_batch_indices(6, 2, max_iters, random.Random(8))
    cfg = DictConfig(dict(max_iters=max_iters, valid_rate=4,
                          lr_drop_ratio=0.2, l2_reg=1e-4))
    opt, sched = TT.make_pcnet_optimizer(net, cfg)

    def loss_fn(x, y, itr):
        if itr == kill_at:
            raise KeyboardInterrupt("simulated kill")
        return TT.compute_loss(net(x, scene, mask), y, "l1+ssim",
                               ssim_weight=1.0 if itr > 2 else 0.0)

    TT.train_model(loss_fn, net, opt, sched, dict(inputs=prj, targets=cam),
                   idx, cfg, "cpu", resume_path=resume)
    return net.state_dict()


def test_resume_after_a_kill_reproduces_the_trajectory(tmp_path):
    full = _toy_run(tmp_path, None)
    rp = str(tmp_path / "run.flax.resume.npz")
    with pytest.raises(KeyboardInterrupt):
        _toy_run(tmp_path, rp, kill_at=5)
    assert os.path.exists(rp)        # the snapshot of iteration 4
    resumed = _toy_run(tmp_path, rp)
    assert not os.path.exists(rp)    # removed on completion
    for k, v in full.items():
        assert torch.equal(resumed[k], v), k

    # a snapshot of another run (other index plan) is discarded
    with pytest.raises(KeyboardInterrupt):
        _toy_run(tmp_path, rp, kill_at=9, max_iters=12)
    assert os.path.exists(rp)
    fresh = _toy_run(tmp_path, rp)
    for k, v in full.items():
        assert torch.equal(fresh[k], v), k
    # a snapshot of another layout (spaa_tpu's leaves) is discarded too
    np.savez(rp, leaf_0=np.zeros(3), iter=np.int64(4))
    for k, v in _toy_run(tmp_path, rp).items():
        assert torch.equal(full[k], v), k


# --------------------------------------------------------------------- log
def test_log_table_matches_pandas_writer(tmp_path):
    rows = [["s1", "PCNet", "l1+ssim", 16, 16, 3, 20.123456, 0.1, 0.9,
             3.0, 5.5, 2.25],
            ["s2", "PCNet", "l1+ssim", 16, 16, 3, 21.0, 0.2, 0.8, 3.5, 5.0,
             2.5]]
    ret, jtxt, jxls = JL.init_log_file(str(tmp_path / "jax"))
    table, ttxt, txls = TL.init_log_file(str(tmp_path / "port"))
    for r in rows:
        ret.loc[len(ret)] = r
        table.append(r)
    JL.write_log_file(ret, jtxt, None)
    TL.write_log_file(table, ttxt, None)
    assert open(ttxt).read() == open(jtxt).read()
    sel = ret.loc[ret["Model"] == "PCNet"]
    ret.loc[len(ret)] = sel.mean(axis=0, numeric_only=True)
    ret.loc[len(ret) - 1, ["Setup", "Model"]] = ["[mean]_2_setups", "PCNet"]
    TL.add_mean_row(table, "PCNet", 2)
    JL.write_log_file(ret, jtxt, jxls)
    TL.write_log_file(table, ttxt, txls)
    assert open(ttxt).read() == open(jtxt).read()
    # the .xlsx half, part for part
    with zipfile.ZipFile(jxls) as zj, zipfile.ZipFile(txls) as zt:
        for name in zj.namelist():
            assert zt.read(name) == zj.read(name), name
