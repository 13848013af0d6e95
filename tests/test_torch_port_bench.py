"""Port parity: ``spaa_tpu_torch.bench`` and its two tools against the root
``bench.py`` (the JAX package's headline benchmark).

- the sweep layout equals ``bench.py:228-237``'s arrays, exactly;
- the emulated converged warp: ``bench.py:183-191``'s edits on the same
  initial tree (``spaa_tpu``'s ``PCNet.init(PRNGKey(0))``), float64,
  <=1e-12; the port's emulated PCNet is those edits on its own draw of
  that tree, which is held as ``tests/test_torch_port_train.py`` holds
  the initial draw (uniform draws exactly, normal draws within 3 float32
  ulps: XLA's ``log1p``);
- a 3-iteration training segment through ``train_model`` against a
  ``lax.scan`` of ``bench.py``'s ``step`` (``:346-353``) at a small camera
  size, float64: losses and parameters <=1e-9;
- the chained-inference sum against ``bench.py``'s ``chained``
  (``:282-289``) on the committed checkpoint and fixture, 2 images and 3
  forwards, float64, <=1e-8 relative;
- one run of the bench's ``main`` with ``--device cpu`` at cut constants
  on the committed fixture and checkpoint: one JSON line of ``bench.py``'s
  keys plus the provenance, finite values, ``warp_source`` the trained
  checkpoint, no summarize metric without attack outputs;
- without ``--device`` and with no GPU, the bench and the tools raise;
- the bf16 tool's table comparison and its exit codes.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import math
import os
import shutil
from functools import partial
from os.path import join

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from jax import enable_x64

from spaa_tpu.attack.orchestrate import make_pcnet_fn as jax_make_pcnet_fn
from spaa_tpu.models import PCNet as JaxPCNet
from spaa_tpu.train import train as JT
from spaa_tpu.train.pipeline import TrainedModel as JaxTrainedModel
from spaa_tpu.utils.jaxtools import host_init
import spaa_tpu_torch.bench as B
from spaa_tpu_torch.attack.orchestrate import make_pcnet_fn
from spaa_tpu_torch.models.pcnet import PCNet
from spaa_tpu_torch.train.pipeline import TrainedModel, _frozen, _load_weights
from spaa_tpu_torch.utils.table import Table
from spaa_tpu_torch.utils.threefry import prng_key
from spaa_tpu_torch.weights import pcnet_params, pcnet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_NAME = "sim_setup_PCNet_l1+ssim_500_24_2000_0.001_0.2_800_0.0001.flax"
FIXTURE = join(REPO, "spaa_tpu_torch", "assets", "sim_setup")
CAM, PRJ = (24, 32), (32, 32)
jax_ssim_mod = importlib.import_module("spaa_tpu.ops.ssim")
# bench.py:552-569, summarize's key apart
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA = {"pcnet_infer_fps", "pcnet_train_iters_per_s",
               "pcnet_train_2000it_s", "pcnet_train_e2e_s",
               "train_data_upload_s", "warp_source", "clf_weights_source",
               "sweep_wallclock_s"}
PROVENANCE = {"device", "power_limit_w", "attack_dtype", "reps",
              "train_e2e_iters", "warp_launches"}


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def ssim64(monkeypatch):
    orig = jax_ssim_mod._gaussian_1d
    monkeypatch.setattr(jax_ssim_mod, "_gaussian_1d",
                        lambda ws, s: orig(ws, s).astype(np.float64))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_init(cam_hw, prj_hw):
    """``bench.py``'s initial PCNet tree (``host_init`` of the jitted
    ``init`` under ``PRNGKey(0)``)."""
    model = JaxPCNet(out_size=cam_hw)
    return host_init(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *prj_hw, 3)),
        jnp.zeros((1, *cam_hw, 3)), jnp.ones((*cam_hw, 1)))["params"])


def _bench_py_emulation(params):
    """``bench.py:186-191`` on a param tree."""
    params = dict(params)
    params["warping_net"] = dict(params["warping_net"])
    params["warping_net"]["affine_mat"] = jnp.asarray(
        [[[0.85, 0.02, 0.01], [-0.02, 0.85, -0.01]]], jnp.float32)
    params["warping_net"]["grid_refine_net"] = jax.tree.map(
        lambda x: x * 0.01, params["warping_net"]["grid_refine_net"])
    return params


def test_sweep_layout_matches_bench_py():
    tgt, targeted, w, dt, prj_init, camde = B.sweep_layout()
    # bench.py:228-237
    n_configs, batch = 12, 132
    want_tgt = jnp.tile(jnp.arange(11, dtype=jnp.int32) * 37 % 1000,
                        n_configs)
    want_targeted = jnp.tile(jnp.asarray([True] * 10 + [False]), n_configs)
    wcfg = jnp.asarray([[0.0, 1.0, 0.0]] * 4 + [[0.0, 0.0, 1.0]] * 4
                       + [[0.0, 1.0, 1.0]] * 4)
    want_w = jnp.repeat(wcfg, 11, axis=0)
    want_dt = jnp.repeat(jnp.asarray([5.0, 7.0, 9.0, 11.0] * 3), 11)
    want_prj = jnp.full((batch, 256, 256, 3), 0.5)
    assert B.BATCH == batch and B.N_CONFIGS == n_configs
    for got, want in ((tgt, want_tgt), (targeted, want_targeted),
                      (w, want_w), (dt, want_dt), (prj_init, want_prj)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert camde == (4 * 11, batch)


def test_emulated_warp_edits_match_bench_py_f64():
    """The edits alone, on the same (``spaa_tpu``'s) initial tree."""
    init = _jax_init(CAM, PRJ)
    with enable_x64():
        want = _flat(_bench_py_emulation(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), init)))
    net = PCNet(out_size=CAM)
    net.load_state_dict(pcnet_state_dict(jax.tree.map(np.asarray, init),
                                         np.float64))
    got = _flat(pcnet_params(B.emulate_converged_warp(
        net.double()).state_dict()))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12,
                                   err_msg=k)


def test_emulated_pcnet_matches_spaa_tpu(monkeypatch):
    """The port's emulated PCNet is its own draw of ``spaa_tpu``'s initial
    weights for key 0, held against ``bench.py``'s ``host_init`` draw,
    with the edits above."""
    monkeypatch.setattr(B, "CAM_HW", CAM)
    want = _flat(_jax_init(CAM, PRJ))
    draw = PCNet(out_size=CAM).init_weights(prng_key(0))
    got = _flat(pcnet_params(draw.state_dict()))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
        assert (g == w).mean() >= 0.95, k
        ulps = np.abs(g.view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= 3, k
        if "bias" in k or "affine_mat" in k or "theta" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
    edited = _flat(pcnet_params(B.emulate_converged_warp(draw).state_dict()))
    emulated = _flat(pcnet_params(B.emulated_pcnet().state_dict()))
    for k, v in edited.items():
        np.testing.assert_array_equal(emulated[k], v, err_msg=k)


def test_train_segment_matches_bench_py_step_f64(monkeypatch, ssim64):
    for name, v in (("CAM_HW", CAM), ("PRJ_HW", PRJ), ("STEP_PAIRS", 6),
                    ("STEP_BATCH", 3), ("STEP_ITERS", 3)):
        monkeypatch.setattr(B, name, v)
    scene, prj, cam, idx = B.step_inputs()
    assert idx.shape == (3, 3) and prj.shape == (6, *PRJ, 3)
    model = PCNet(out_size=CAM).init_weights(prng_key(0)).double()
    # a copy: the float64 leaves would share the parameters' memory
    p0 = jax.tree.map(lambda a: np.array(a, np.float64),
                      pcnet_params(model.state_dict()))
    losses = []
    B.train_segment(model, torch.tensor(scene, dtype=torch.float64),
                    torch.ones((*CAM, 1), dtype=torch.float64),
                    dict(inputs=torch.from_numpy(prj),
                         targets=torch.from_numpy(cam)),
                    idx, torch.device("cpu"), step_losses=losses)

    with enable_x64():
        # bench.py:318-360 at the small size, float64
        jm = JaxPCNet(out_size=CAM)
        mask = jnp.ones((*CAM, 1), jnp.float64)
        scene_j = jnp.asarray(scene, jnp.float64)
        cfg = JT.get_model_train_cfg(["PCNet"], single=True)
        tx = JT.make_pcnet_optimizer(cfg)
        params = jax.tree.map(jnp.asarray, p0)

        def loss_fn(p, x, y, itr):
            infer = jm.apply({"params": p}, x, scene_j, mask)
            w = (itr > 400).astype(jnp.float32)
            return JT.compute_loss(infer, y, "l1+ssim", ssim_weight=w)

        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

        def step(prj, cam, carry, idx_itr):
            p, o = carry
            i, itr = idx_itr
            x = jnp.take(prj, i, axis=0)
            y = jnp.take(cam, i, axis=0)
            (loss, _), g = grad_fn(p, x, y, itr)
            upd, o = tx.update(g, o, p)
            return (jax.tree.map(lambda a, u: a + u, p, upd), o), loss

        (p_j, _), want = jax.lax.scan(
            partial(step, jnp.asarray(prj, jnp.float64),
                    jnp.asarray(cam, jnp.float64)),
            (params, tx.init(params)),
            (jnp.asarray(idx), jnp.arange(3, dtype=jnp.int32)))
        want, p_j = np.asarray(want), _flat(p_j)
    got = np.asarray(losses)[:, 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    got_p = _flat(pcnet_params(model.state_dict()))
    for k, v in p_j.items():
        np.testing.assert_allclose(got_p[k], v, rtol=0, atol=1e-9, err_msg=k)


def _fixture_scene_mask():
    return B._load_setup_scene_mask(FIXTURE, lambda m: None)


def test_chained_forwards_match_bench_py_f64():
    scene, mask = _fixture_scene_mask()
    setup_info = {"prj_im_sz": [256, 256]}
    prj = np.random.default_rng(2).random((2, 256, 256, 3))
    with open(join(REPO, "checkpoint", CKPT_NAME), "rb") as f:
        params = serialization.msgpack_restore(f.read())
    with enable_x64():
        jt = JaxTrainedModel(
            JaxPCNet(out_size=(240, 320)),
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params),
            jnp.asarray(mask, jnp.float64), np.asarray(scene, np.float64),
            setup_info, None, "PCNet")
        jax_apply, jax_state = jax_make_pcnet_fn(
            jt, use_pallas_warp=False, compute_dtype="float32")

        @jax.jit
        def chained(st, prj):             # bench.py:282-289, 3 forwards
            def body(acc, i):
                out = jax_apply(st, prj + i * 1e-8)
                return acc + jnp.mean(out), ()
            acc, _ = jax.lax.scan(body, 0.0,
                                  jnp.arange(3, dtype=jnp.float32))
            return acc

        want = float(chained(jax_state, jnp.asarray(prj)))
    model = _frozen(_load_weights(PCNet(out_size=(240, 320)),
                                  join(REPO, "checkpoint", CKPT_NAME),
                                  torch.float64), "cpu", torch.float64)
    trained = TrainedModel(model, torch.tensor(mask, dtype=torch.float64),
                           torch.tensor(scene, dtype=torch.float64),
                           setup_info, None, "PCNet")
    with torch.no_grad():
        got = float(B.chained_forwards(make_pcnet_fn(trained),
                                       torch.from_numpy(prj), 3))
    assert math.isfinite(want) and want != 0.0
    assert abs(got - want) <= 1e-8 * abs(want)


def _bench_root(tmp_path):
    """The committed checkpoint and fixture laid out as the bench looks
    for them under ``$SPAA_BENCH_DATA_ROOT``."""
    os.makedirs(tmp_path / "checkpoint")
    shutil.copy(join(REPO, "checkpoint", CKPT_NAME),
                tmp_path / "checkpoint" / CKPT_NAME)
    shutil.copytree(FIXTURE, tmp_path / "sim_benchmark" / "setups"
                    / "sim_setup")
    return str(tmp_path)


def test_bench_main_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SPAA_BENCH_DATA_ROOT", _bench_root(tmp_path))
    monkeypatch.setenv("SPAA_BENCH_NO_REGEN", "1")
    for name, v in (("CLASSIFIERS", ("resnet18",)), ("BATCH", 2),
                    ("ATTACK_ITERS", 2), ("REPS", 1), ("INFER_BATCH", 2),
                    ("INFER_CHAIN", 2), ("INFER_REPS", 1),
                    ("STEP_PAIRS", 4), ("STEP_BATCH", 2), ("STEP_ITERS", 2),
                    ("STEP_REPS", 1), ("E2E_PAIRS", (4, 2))):
        monkeypatch.setattr(B, name, v)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        B.main(["--device", "cpu", "--train-iters", "2"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert set(rec) == BENCH_KEYS
    extra = rec["extra"]
    # no attack outputs under the fixture: no summarize metric
    assert set(extra) == BENCH_EXTRA | PROVENANCE, sorted(extra)
    assert rec["metric"] == "spaa_attack_config_wallclock"
    assert rec["unit"] == "s"
    for v in [rec["value"], rec["vs_baseline"]] + [
            extra[k] for k in BENCH_EXTRA - {"warp_source",
                                             "clf_weights_source"}]:
        assert isinstance(v, float) and math.isfinite(v) and v > 0, v
    assert rec["vs_baseline"] == pytest.approx(42.5 / rec["value"])
    assert extra["warp_source"] == "trained_ckpt"
    assert extra["clf_weights_source"] == "random"
    assert extra["device"] == "cpu" and extra["power_limit_w"] is None
    assert extra["attack_dtype"] == "float32"
    assert extra["reps"] == 1 and extra["train_e2e_iters"] == 2
    # the plain warp on the CPU counts no launch
    assert extra["warp_launches"] == {"fixed_warp_fwd": 0,
                                      "fixed_warp_bwd": 0}
    assert "trained PCNet checkpoint loaded" in err.getvalue()


def test_bench_and_tools_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tool("torch_make_bench_ckpt").main([str(tmp_path)])
    root = tmp_path / "with_setup"
    os.makedirs(root / "sim_benchmark" / "setups" / "sim_setup")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tool("torch_bf16_equiv_check").main(["--data-root", str(root)])


def _stats(rows):
    tool = _tool("torch_bf16_equiv_check")
    return Table(["Setup", *tool.KEYS, *tool.SUCCESS_COLS], rows)


def test_bf16_tool_compares_success_tables(tmp_path, capsys):
    tool = _tool("torch_bf16_equiv_check")
    rng = np.random.default_rng(5)
    rows = [["sim_setup", loss, d, clf, *rng.integers(0, 11, 6) / 10]
            for loss in ("caml2", "camdE", "camdE_caml2") for d in (5, 11)
            for clf in ("resnet18", "vgg16")]
    a = _stats(rows)
    b = _stats(rows[::-1])                      # the same rows, reordered
    assert tool.compare_success(a, b) == []
    assert tool.report([], len(a)) == 0
    assert "IDENTICAL" in capsys.readouterr().out
    changed = [list(r) for r in rows[::-1]]
    changed[3][tool.SUCCESS_COLS.index("T.top-5_real") + 4] += 0.2
    diffs = tool.compare_success(a, _stats(changed))
    assert [(c, n) for c, _, n in diffs] == [("T.top-5_real", 1)]
    assert diffs[0][1] == pytest.approx(0.2)
    assert tool.report(diffs, len(a)) == 1
    assert "DIFFERS: T.top-5_real: 1 rows differ" in capsys.readouterr().out
    with pytest.raises(ValueError, match="different rows"):
        tool.compare_success(a, _stats(rows[1:]))
    assert tool.main(["--data-root", str(tmp_path)]) == 2
    assert "no trained sim setup" in capsys.readouterr().out
