"""Port parity: ``spaa_tpu_torch.parallel`` against ``spaa_tpu.parallel``.

The JAX side runs as ``tests/test_parallel.py`` runs it, on a 2-device
``setup`` mesh of the virtual CPU devices of ``tests/conftest.py``; the
port's mesh is ``make_mesh(2, device="cpu")``. Parameters cross over
through ``spaa_tpu_torch/weights.py``.

- training (S = 2, camera 16x24, projector 12x12) against
  ``train_pcnet_multi_setup`` in float64: an SGD step on each curriculum
  branch <= 1e-12, six production-Adam steps across the curriculum
  switch <= 1e-9, and the same Adam check for the CompenNet++ variant;
- training port against port: S = 2 on one device, two S = 1 calls and
  the two-device mesh <= 1e-12; ``segment=3`` and ``segment=None`` bitwise
  over 10 iterations; an indivisible S raises;
- the mesh helpers: contiguous chunks, replicas, ``shard_attack_inputs``'
  argument order;
- the cache fillers on two 64x64 / 64x48 sims (12 pairs, 6 iterations):
  both setups trained, then cached; the checkpoint files those of
  ``spaa_tpu``'s fillers for the same config; the port's ``train_eval_*``
  loads them without retraining; one ``init_CompenNet_`` checkpoint;
- the attack primitives on ``tests/test_parallel.py``'s toy PCNet,
  CompenNet++ and classifier, S = 2 on two devices, float64, <= 1e-5; a
  wrong wave size raises;
- the wave drivers against the port's sequential driver on two tiny
  setups (2 attack iterations), with a two-CPU mesh and with none: the
  same PNG files, decoded uint8 within 1 count;
- ``reproduce_paper_results --sim --num-sim-setups 2 --multi-setup-train
  --multi-setup-chunk 2 --multi-setup-attack`` on two tiny sim setups
  (budgets cut by patching the port's config factories): the phases, the
  two JSON fields and the ``stats_all`` rows.

The drivers and the entry point are held port against port, so a small
seeded classifier stands in for the zoo's networks there.
"""

import glob
import importlib
import json
import os
import random
import shutil
from os.path import join

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import enable_x64

import spaa_tpu.parallel as JP
from spaa_tpu.models import CompenNetPlusplus as JaxCompenNetPP
from spaa_tpu.models import PCNet as JaxPCNet
from spaa_tpu.train import train as JT
from spaa_tpu.utils.config import DictConfig
import spaa_tpu_torch.parallel as TP
from spaa_tpu_torch.models.compen_net import CompenNetPlusplus
from spaa_tpu_torch.models.pcnet import PCNet
from spaa_tpu_torch.parallel.mesh import make_mesh
from spaa_tpu_torch.train import train as TT
from spaa_tpu_torch.weights import pcnet_params, pcnet_state_dict

jax_ssim_mod = importlib.import_module("spaa_tpu.ops.ssim")
S, N, B, CURR = 2, 8, 4, 2
CAM, PRJ = (16, 24), (12, 12)


@pytest.fixture
def ssim64(monkeypatch):
    orig = jax_ssim_mod._gaussian_1d
    monkeypatch.setattr(jax_ssim_mod, "_gaussian_1d",
                        lambda ws, s: orig(ws, s).astype(np.float64))


def test_all_matches_spaa_tpu():
    assert TP.__all__ == JP.__all__
    for name in TP.__all__:
        assert callable(getattr(TP, name)), name


# ---------------------------------------------------------------- training
@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run thousands of small ops, whose
    thread-pool barriers stall when the test workers share the host's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setups(variant):
    """S setups: float64 scenes and masks, uint8 pairs, and ``spaa_tpu``'s
    initial parameters as the port draws them (float32 values held in
    float64), as the trees ``spaa_tpu`` takes."""
    from spaa_tpu_torch.utils.threefry import prng_key
    rng = np.random.default_rng(2)
    if variant == "pcnet":
        jm, in_hw, out_hw = JaxPCNet(out_size=CAM), PRJ, CAM
    else:
        jm, in_hw, out_hw = JaxCompenNetPP(out_size=PRJ), CAM, PRJ
    out = dict(scenes=[], masks=[], params=[], inputs=[], targets=[])
    for s in range(S):
        net = PCNet(out_size=CAM) if variant == "pcnet" else \
            CompenNetPlusplus(PRJ)
        p = pcnet_params(net.init_weights(prng_key(s)).state_dict())
        out["scenes"].append(rng.random((1, *CAM, 3)))
        out["masks"].append((rng.random((*CAM, 1)) > 0.2).astype(np.float64))
        out["params"].append(jax.tree.map(
            lambda a: np.asarray(a, np.float64), p))
        out["inputs"].append(rng.integers(0, 256, (N, *in_hw, 3), np.uint8))
        out["targets"].append(rng.integers(0, 256, (N, *out_hw, 3), np.uint8))
    return jm, {k: np.stack(v) if k != "params" else v
                for k, v in out.items()}


def _unit64(u8):
    """The port's minibatch values (uint8 / 255 in float32, then the
    model's float64), which ``spaa_tpu``'s float64 run is fed directly."""
    return (u8.astype(np.float32) / np.float32(255)).astype(np.float64)


def _jax_train(jm, d, tx, idx, variant, curr):
    with enable_x64():
        params = [jax.tree.map(jnp.asarray, p) for p in d["params"]]
        if variant == "pcnet":
            out, losses, _ = JP.train_pcnet_multi_setup(
                jm.apply, params, tx, d["scenes"], d["masks"],
                _unit64(d["inputs"]), _unit64(d["targets"]), idx,
                curriculum_iter=curr)
        else:
            out, losses, _ = JP.train_compennet_pp_multi_setup(
                jm.apply, params, tx, d["scenes"], _unit64(d["inputs"]),
                _unit64(d["targets"]), idx)
        return [jax.tree.map(np.asarray, p) for p in out], losses


def _port_train(d, tx, idx, variant, curr, **kw):
    sds = [pcnet_state_dict(p, np.float64) for p in d["params"]]
    if variant == "pcnet":
        out, losses, _ = TP.train_pcnet_multi_setup(
            PCNet(out_size=CAM), sds, tx, d["scenes"], d["masks"],
            d["inputs"], d["targets"], idx, curriculum_iter=curr, **kw)
    else:
        out, losses, _ = TP.train_compennet_pp_multi_setup(
            CompenNetPlusplus(PRJ), sds, tx, d["scenes"], d["inputs"],
            d["targets"], idx, **kw)
    return [pcnet_params(p) for p in out], losses


def _assert_close(got, want, atol):
    for g, w in zip(got, want):
        flat_w = dict(jax.tree_util.tree_leaves_with_path(w))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(g))
        assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
        for k, v in flat_w.items():
            np.testing.assert_allclose(flat_g[k], v, rtol=0, atol=atol,
                                       err_msg=str(k))


def _idx(iters):
    return JT.sample_batch_indices(N, B, iters, random.Random(7))


def _sgd(m):
    return torch.optim.SGD(m.parameters(), lr=0.5), None


def test_sgd_steps_match_spaa_tpu_f64(ssim64):
    """Two SGD steps with the curriculum switch at 0: the first on the l1
    branch, the second on l1+ssim (one program on the JAX side)."""
    jm, d = _setups("pcnet")
    idx = _idx(2)
    want_p, want_l = _jax_train(jm, d, optax.sgd(0.5), idx, "pcnet", 0)
    got_p, got_l = _port_train(d, _sgd, idx, "pcnet", 0)
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=1e-12)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(want_p[0]), jax.tree.leaves(d["params"][0])))
    assert moved > 1e-4              # the steps are not a no-op
    _assert_close(got_p, want_p, 1e-12)


@pytest.mark.parametrize("variant", ["pcnet", "compennet_pp"])
def test_adam_steps_match_spaa_tpu_f64(ssim64, variant):
    """Six steps of the production optimizer (PCNet's three Adam groups
    across the curriculum switch, or CompenNet++'s one Adam)."""
    jm, d = _setups(variant)
    cfg = DictConfig(dict(lr=1e-3, lr_drop_ratio=0.2, lr_drop_rate=800,
                          l2_reg=1e-4, max_iters=6))
    if variant == "pcnet":
        jtx = JT.make_pcnet_optimizer(cfg)

        def ttx(m):
            return TT.make_pcnet_optimizer(m, cfg)
    else:
        jtx = JT.make_compennet_pp_optimizer(cfg)

        def ttx(m):
            return TT.make_compennet_pp_optimizer(m, cfg)
    idx = _idx(6)
    want_p, want_l = _jax_train(jm, d, jtx, idx, variant, CURR)
    got_p, got_l = _port_train(d, ttx, idx, variant, CURR)
    assert got_l.shape == (6, S)
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=1e-9)
    _assert_close(got_p, want_p, 1e-9)


def test_stacked_single_and_mesh_training_agree():
    """S = 2 on one device (both setups in one call), two S = 1 calls and
    the two-device mesh (one setup a thread), production Adam, float64."""
    _, d = _setups("pcnet")
    cfg = DictConfig(dict(lr_drop_ratio=0.2, l2_reg=1e-4))

    def tx(m):
        return TT.make_pcnet_optimizer(m, cfg)

    idx = _idx(6)
    stacked = _port_train(d, tx, idx, "pcnet", CURR)
    mesh = _port_train(d, tx, idx, "pcnet", CURR,
                       mesh=make_mesh(2, axis="setup", device="cpu"))
    singles = [_port_train({k: v[s:s + 1] for k, v in d.items()},
                           tx, idx, "pcnet", CURR) for s in range(S)]
    single = ([p for sp in singles for p in sp[0]],
              np.concatenate([sp[1] for sp in singles], 1))
    for got in (stacked, mesh):
        np.testing.assert_allclose(got[1], single[1], rtol=0, atol=1e-12)
        _assert_close(got[0], single[0], 1e-12)
    with pytest.raises(ValueError, match="not divisible"):
        _port_train({k: v + v[:1] if k == "params" else
                     np.concatenate([v, v[:1]]) for k, v in d.items()},
                    tx, idx, "pcnet", CURR,
                    mesh=make_mesh(2, axis="setup", device="cpu"))


def test_segments_are_bitwise_equal():
    """Ten iterations read back every 3 (3, 3, 3, 1) or once: the same
    parameters and losses bit for bit, on one device and on the mesh."""
    _, d = _setups("pcnet")
    d = dict(d, params=[jax.tree.map(lambda a: a.astype(np.float32), p)
                        for p in d["params"]])
    idx = _idx(10)

    def tx(m):
        return torch.optim.Adam(m.parameters(), lr=1e-3), None

    for mesh in (None, make_mesh(2, axis="setup", device="cpu")):
        sds = [pcnet_state_dict(p) for p in d["params"]]
        runs = [TP.train_pcnet_multi_setup(
            PCNet(out_size=CAM), sds, tx, d["scenes"].astype(np.float32),
            d["masks"].astype(np.float32), d["inputs"], d["targets"], idx,
            mesh=mesh, curriculum_iter=4, segment=seg) for seg in (None, 3)]
        one, seg = runs
        for a, b in zip(one[0], seg[0]):
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert np.array_equal(one[1], seg[1])
        assert np.array_equal(one[2], seg[2])


def test_mesh_helpers():
    mesh = make_mesh(2, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.axis == "data"
    tree = {"a": np.arange(12.0).reshape(4, 3), "b": [torch.arange(4)]}
    parts = TP.shard_batch(tree, mesh)
    assert [p["a"].tolist() for p in parts] == [[[0, 1, 2], [3, 4, 5]],
                                                [[6, 7, 8], [9, 10, 11]]]
    assert [p["b"][0].tolist() for p in parts] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="does not divide"):
        TP.shard_batch(np.zeros(3), mesh)
    reps = TP.replicate(tree, mesh)
    assert len(reps) == 2 and all(np.array_equal(r["a"], tree["a"])
                                  for r in reps)
    args = [np.full((4, 1), k) for k in range(8)]
    out = TP.shard_attack_inputs(mesh, *args)
    assert [int(o[1][0, 0]) for o in out] == list(range(8))
    assert [o[0].shape[0] for o in out] == [4, 4, 4, 2, 2, 2, 2, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(2)


# ------------------------------------------------------------ cache fillers
SIM_INFO = dict(prj_im_sz=[64, 64], cam_im_sz=[64, 48],
                classifier_crop_sz=[48, 48])
NAMES = ["ms1", "ms2"]


def _make_sims(root):
    from spaa_tpu_torch.utils.sim_procams import (DEFAULT_SIM_SETUP_INFO,
                                                  SimProCams)
    for k, name in enumerate(NAMES):
        info = dict(DEFAULT_SIM_SETUP_INFO, **SIM_INFO)
        SimProCams(info, seed=11 + k).make_setup(root, name, num_train=12,
                                                 num_test=4)


def _model_cfg(get_cfg, root, model, **kw):
    mc = get_cfg(None, root, NAMES, **kw)
    mc.model_list = [model]
    mc.max_iters = 6
    mc.valid_rate = 6
    mc.init_max_iters = 4
    return mc


def _ckpts(root):
    return sorted(os.path.basename(c) for c in
                  glob.glob(join(root, "..", "checkpoint", "*.flax")))


def _jax_filler_names(monkeypatch, root):
    """The checkpoint files ``spaa_tpu``'s two fillers write for the same
    configs, from their own control flow (skip, grouping, keys); their
    training, draws and validation are stubbed out, so no program
    compiles."""
    import spaa_tpu.parallel.multi_setup as JMS
    import spaa_tpu.train.pipeline as JPL
    import spaa_tpu.utils.jaxtools as JJT
    from spaa_tpu.train.train import get_model_train_cfg as jcfg

    def fake_train(apply, params_list, *a, **k):
        zeros = np.zeros((1, len(params_list)), np.float32)
        return params_list, zeros, zeros

    monkeypatch.setattr(JMS, "train_pcnet_multi_setup", fake_train)
    monkeypatch.setattr(JMS, "train_compennet_pp_multi_setup", fake_train)
    monkeypatch.setattr(JT, "make_evaluator",
                        lambda *a, **k: (lambda p: (0.0, 0.0, 0.0)))
    monkeypatch.setattr(JPL, "_build_pcnet",
                        lambda *a: (JaxPCNet(out_size=(2, 2)), {}))
    monkeypatch.setattr(JPL, "_set_affine", lambda p, c, inverse=False: p)
    monkeypatch.setattr(JPL, "init_compennet", lambda *a: (None, {}))
    monkeypatch.setattr(JJT, "host_init", lambda f: {})
    JMS.pretrain_pcnets_multi_setup(_model_cfg(jcfg, root, "PCNet"),
                                    mesh=None, chunk=2)
    JMS.pretrain_compennets_pp_multi_setup(
        _model_cfg(jcfg, root, "CompenNet++"), mesh=None, chunk=2)
    return _ckpts(root)


def test_pretrain_fills_the_checkpoint_cache(tmp_path, monkeypatch):
    from spaa_tpu_torch.train.pipeline import (train_eval_compennet_pp,
                                               train_eval_pcnet)
    root = str(tmp_path / "port" / "data")
    _make_sims(root)
    jroot = str(tmp_path / "jax" / "data")
    shutil.copytree(root, jroot)
    cfg = TT.get_model_train_cfg
    fillers = ((TP.pretrain_pcnets_multi_setup, "PCNet"),
               (TP.pretrain_compennets_pp_multi_setup, "CompenNet++"))
    for fill, model in fillers:
        rows = fill(_model_cfg(cfg, root, model), chunk=2, device="cpu")
        assert [r["status"] for r in rows] == ["trained", "trained"]
        assert all(np.isfinite(r["PSNR"]) and r["PSNR"] > 5 for r in rows)
    names = _ckpts(root)
    assert sum(n.startswith("init_CompenNet_") for n in names) == 1
    assert [n for n in names if not n.startswith("init_")] == \
        _jax_filler_names(monkeypatch, jroot)
    for fill, model in fillers:        # everything cached the second time
        rows = fill(_model_cfg(cfg, root, model), chunk=2, device="cpu")
        assert [r["status"] for r in rows] == ["cached", "cached"]
    ckpts = glob.glob(join(root, "..", "checkpoint", "*.flax"))
    mtimes = {c: os.path.getmtime(c) for c in ckpts}
    for train_eval, model in ((train_eval_pcnet, "PCNet"),
                              (train_eval_compennet_pp, "CompenNet++")):
        _, table, _ = train_eval(_model_cfg(cfg, root, model,
                                            load_pretrained=True), "cpu")
        rows = [r for r in table.typed_rows() if r[0] in NAMES]
        assert len(rows) == 2 and all(np.isfinite(r[6]) for r in rows)
    assert {c: os.path.getmtime(c) for c in ckpts} == mtimes, \
        "the pipeline retrained instead of loading"


# -------------------------------------------------------- attack primitives
HP, H, W, NCLS = 16, 12, 16, 7


def _resize_mats():
    """``jax.image.resize``'s linear maps HP -> H and HP -> W as matrices,
    so the port's toy PCNet resizes as ``tests/test_parallel.py``'s."""
    with enable_x64():
        eye = jnp.eye(HP, dtype=jnp.float64)
        return (np.array(jax.image.resize(eye, (H, HP), "linear")),
                np.array(jax.image.resize(eye, (W, HP), "linear")))


def test_spaa_attack_multi_setup_matches_spaa_tpu():
    from spaa_tpu.attack.spaa import SpaaConfig as JCfg
    from spaa_tpu_torch.attack.spaa import SpaaConfig
    B = 6
    rng = np.random.default_rng(3)
    k_cl = rng.normal(0, 0.1, (H * W * 3, NCLS))
    states, scenes, prjs, tgts, tgds, ws, dts = [], [], [], [], [], [], []
    for s in range(S):
        states.append({"k": rng.normal(0, 0.3, (3, 3)), "bias": 0.3 + 0.1 * s})
        scenes.append(rng.random((1, H, W, 3)))
        prjs.append(rng.random((B, HP, HP, 3)))
        tgts.append(rng.integers(0, NCLS, B).astype(np.int32))
        tgds.append(np.asarray([True, False] * (B // 2)))
        ws.append(np.tile(np.asarray([0.0, 1.0, 1.0]), (B, 1)))
        dts.append(np.full((B,), 2.0))
    stacks = [np.stack(a) for a in (scenes, prjs, tgts, tgds, ws, dts)]

    def jax_pcnet(state, prj):
        x = jax.image.resize(prj, (prj.shape[0], H, W, 3), "linear")
        return jnp.clip(x @ state["k"] * 0.5 + state["bias"], 0.0, 1.0)

    with enable_x64():
        want = JP.spaa_attack_multi_setup(
            jax_pcnet, lambda p, cam: cam.reshape(cam.shape[0], -1) @ p,
            [jax.tree.map(jnp.asarray, st) for st in states],
            jnp.asarray(k_cl), *stacks, mesh=JP.make_mesh(2, axis="setup"),
            cfg=JCfg(iters=3))
        want = [np.asarray(w) for w in want]
    rh, rw = (torch.from_numpy(m) for m in _resize_mats())

    def port_pcnet(st):
        k = torch.from_numpy(st["k"])
        return lambda prj: torch.clamp(torch.einsum(
            "hi,bijc,wj->bhwc", rh, prj, rw) @ k * 0.5 + st["bias"], 0, 1)

    mesh = make_mesh(2, axis="setup", device="cpu")
    got = TP.spaa_attack_multi_setup(
        [port_pcnet(st) for st in states],
        lambda p, cam: cam.reshape(cam.shape[0], -1) @ p,
        torch.from_numpy(k_cl), *stacks, mesh=mesh, cfg=SpaaConfig(iters=3))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mesh"):
        TP.spaa_attack_multi_setup(
            [port_pcnet(states[0])], lambda p, cam: cam, k_cl,
            *[a[:1] for a in stacks], mesh=mesh)


def test_percal_attack_multi_setup_matches_spaa_tpu():
    from spaa_tpu.attack.perc_al import PercALConfig as JCfg
    from spaa_tpu_torch.attack.perc_al import PercALConfig
    B = 6
    rng = np.random.default_rng(5)
    k_cl = rng.normal(0, 0.1, (H * W * 3, NCLS))
    params = [{"k": rng.normal(0, 0.3, (3, 3)), "b": 0.4 + 0.05 * s}
              for s in range(S)]
    scenes = np.stack([rng.random((1, H, W, 3)) for _ in range(S)])
    tgts = np.stack([rng.integers(0, NCLS, B) for _ in range(S)])
    targeted = np.tile(np.asarray([True] * (B - 1) + [False]), (S, 1))
    d_thr = np.full((S, B), 2.0)
    with enable_x64():
        want = JP.percal_attack_multi_setup(
            lambda p, cam, scene: jnp.clip((cam - scene) @ p["k"] + p["b"],
                                           0.0, 1.0),
            lambda p, cam: cam.reshape(cam.shape[0], -1) @ p,
            [jax.tree.map(jnp.asarray, p) for p in params],
            jnp.asarray(k_cl), scenes, tgts, targeted, d_thr,
            mesh=JP.make_mesh(2, axis="setup"),
            cfg=JCfg(max_iterations=4, confidence=40))
        want = [np.asarray(w) for w in want]
    mesh = make_mesh(2, axis="setup", device="cpu")
    got = TP.percal_attack_multi_setup(
        lambda p, cam, scene: torch.clamp((cam - scene) @ p["k"] + p["b"],
                                          0.0, 1.0),
        lambda p, cam: cam.reshape(cam.shape[0], -1) @ p, params,
        torch.from_numpy(k_cl), scenes, tgts, targeted, d_thr, mesh=mesh,
        cfg=PercALConfig(max_iterations=4, confidence=40))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mesh"):
        TP.percal_attack_multi_setup(
            None, None, params[:1], k_cl, scenes[:1], tgts[:1],
            targeted[:1], d_thr[:1], mesh=mesh)


# ------------------------------------------------ drivers and entry point
class _StandIn(torch.nn.Module):
    """A small seeded classifier in the zoo's place: the drivers are held
    port against port, so the network only has to give gradients."""
    input_size = (32, 32)

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 4, 4)
        self.fc = torch.nn.Linear(8 * 8 * 8, 1000)

    def init_weights(self, gen):
        for p in self.parameters():
            p.data = torch.randn(p.shape, generator=gen) * 0.1
        return self

    def forward(self, x):
        return self.fc(torch.relu(self.conv(x)).flatten(1))


@pytest.fixture(scope="module")
def stand_in():
    from spaa_tpu_torch.models import classifiers as C
    with pytest.MonkeyPatch.context() as mp:
        for name in ("inception_v3", "resnet18", "vgg16"):
            mp.setitem(C._MODELS, name, _StandIn)
        yield mp


def _attack_cfg(name, root, load_pretrained, setups=NAMES):
    from spaa_tpu_torch.attack.orchestrate import get_attacker_cfg
    cfg = get_attacker_cfg(name, root, setups,
                           load_pretrained=load_pretrained)
    cfg.max_iters = 6            # tiny PCNet / CompenNet++ training
    cfg.init_max_iters = 4       # tiny CompenNet pre-training
    cfg.attack_iters = 2
    cfg.classifier_names = ["inception_v3"]
    if name == "SPAA":
        cfg.stealth_losses = ["caml2", "camdE"]   # camde_range in use
        cfg.d_threshes = [5]
    return cfg


def _adv_pngs(root):
    return sorted(os.path.relpath(p, root) for sub in ("prj/adv",
                                                       "cam/infer/adv")
                  for p in glob.glob(join(root, "setups/*", sub, "**/*.png"),
                                     recursive=True))


@pytest.fixture(scope="module")
def sequential(tmp_path_factory, stand_in):
    """The sequential driver on two tiny setups: trains, attacks, saves."""
    from spaa_tpu_torch.attack.orchestrate import run_projector_based_attack
    top = tmp_path_factory.mktemp("drivers")
    root = str(top / "seq" / "data")
    _make_sims(root)
    for name in ("SPAA", "PerC-AL+CompenNet++"):
        run_projector_based_attack(_attack_cfg(name, root, False),
                                   device="cpu")
    return top, root


@pytest.mark.parametrize("mesh", [2, None], ids=["two_cpu_mesh", "no_mesh"])
def test_wave_drivers_match_the_sequential_driver(sequential, mesh):
    from spaa_tpu_torch.utils.io import imread_u8
    top, root_a = sequential
    tag = "mesh" if mesh else "none"
    root_b = str(top / tag / "data")
    shutil.copytree(str(top / "seq"), str(top / tag))
    for n in NAMES:
        for sub in ("prj/adv", "cam/infer/adv"):
            shutil.rmtree(join(root_b, "setups", n, sub))
    m = make_mesh(mesh, axis="setup", device="cpu") if mesh else None
    TP.run_spaa_attack_multi_setup(_attack_cfg("SPAA", root_b, True),
                                   mesh=m, device="cpu")
    TP.run_percal_attack_multi_setup(
        _attack_cfg("PerC-AL+CompenNet++", root_b, True), mesh=m,
        device="cpu")
    pngs = _adv_pngs(root_a)
    # 2 setups x (prj + cam/infer) x (2 SPAA configs + 1 PerC-AL) x 11
    assert len(pngs) == 2 * 2 * 3 * 11 and _adv_pngs(root_b) == pngs
    worst = max(int(np.abs(imread_u8(join(root_a, p)).astype(np.int16)
                           - imread_u8(join(root_b, p))).max())
                for p in pngs)
    assert worst <= 1, f"wave outputs differ by {worst} counts"


def test_reproduce_multi_setup_flags(tmp_path, monkeypatch, stand_in):
    """``--sim --num-sim-setups 2`` with the three flags; the two sim
    setups exist already, made at 64x64 / 64x48 with 12 pairs, and the
    simulator's default info is patched to that size for the replay; the
    training and attack budgets are cut through the config factories."""
    import spaa_tpu_torch.attack as A
    from spaa_tpu_torch import reproduce_paper_results as TR
    from spaa_tpu_torch.utils import sim_procams
    from spaa_tpu_torch.utils.table import read_csv
    info = dict(sim_procams.DEFAULT_SIM_SETUP_INFO, **SIM_INFO)
    monkeypatch.setattr(sim_procams, "DEFAULT_SIM_SETUP_INFO", info)
    root = str(tmp_path / "sim_benchmark")
    names = ["sim_setup", "sim_setup_2"]
    for k, name in enumerate(names):
        sim_procams.SimProCams(dict(info), seed=7 + 13 * k).make_setup(
            root, name, num_train=12, num_test=4)
    orig_train_cfg = TT.get_model_train_cfg

    def train_cfg(*a, **k):
        mc = orig_train_cfg(*a, **k)
        mc.max_iters, mc.valid_rate, mc.init_max_iters = 6, 6, 4
        return mc

    monkeypatch.setattr(TT, "get_model_train_cfg", train_cfg)
    monkeypatch.setattr(A, "get_attacker_cfg",
                        lambda name, r, setups, load_pretrained=False:
                        _attack_cfg(name, r, load_pretrained, setups))
    phase_json = str(tmp_path / "phases.json")
    TR.main(["--sim", "--num-sim-setups", "2", "--data-root", str(tmp_path),
             "--multi-setup-train", "--multi-setup-chunk", "2",
             "--multi-setup-attack", "--attackers", "SPAA",
             "PerC-AL+CompenNet++", "--device", "cpu",
             "--phase-json", phase_json])
    rec = json.load(open(phase_json))
    assert [p["phase"] for p in rec["phases"]] == [
        "multi_setup_train/PCNet", "multi_setup_train/CompenNet++",
        "attack_wave/SPAA", "replay/SPAA",
        "attack_wave/PerC-AL+CompenNet++", "replay/PerC-AL+CompenNet++",
        "summarize_all"]
    assert rec["multi_setup_train"] is True
    assert rec["multi_setup_attack"] is True
    assert rec["setups"] == names
    # per setup: SPAA's two configs and PerC-AL's one, on the classifier
    # summarize scans first
    assert rec["stats_all_rows"] == 2 * 3
    stats = read_csv(join(root, "setups/stats_all.txt"), sep="\t")
    assert len(stats) == 6 and set(stats["Setup"]) == set(names)
    assert len(_adv_pngs(root)) == 2 * 2 * 3 * 11
    ckpts = _ckpts(root)
    assert sum("PCNet" in c for c in ckpts) == 2
    assert sum("CompenNet++" in c for c in ckpts) == 2
