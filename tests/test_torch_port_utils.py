"""Port parity: the small public functions and the visdom half of
``utils/vis.py`` against ``spaa_tpu``.

- ``ops.tps`` (``tps_d``, ``tps_depth``, ``tps_sparse``), ``ops.color.rgb2xyz``,
  ``ops.metrics.l2_norm_to_mse`` and ``normalize_imagenet`` /
  ``unnormalize_imagenet`` on seeded float64 inputs, <=1e-6;
- ``utils.log``: ``read_log`` and ``log_to_table`` read the same values as
  ``spaa_tpu``'s pandas readers, ``export_setup_info`` writes the same
  bytes;
- ``utils.seed.set_reproducibility`` switches the deterministic-kernel
  flags and leaves ``cudnn.benchmark`` alone;
- ``utils.imgproc_host.resize_linear_np`` against ``cv2.resize``;
- ``vis_pcnet_process``'s montage against ``spaa_tpu``'s on the committed
  PCNet checkpoint at a 24x32 camera size, <=1e-5;
- a fake ``visdom`` module and a fake ``matplotlib`` receive the same calls
  and arrays from both packages; without a server nothing is drawn.
"""

import importlib
import os
import sys
import types
from os.path import join

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from jax import enable_x64

import spaa_tpu.ops.color as JC
import spaa_tpu.ops.metrics as JM
import spaa_tpu.utils.log as JL
import spaa_tpu.utils.vis as JV
from spaa_tpu.models import PCNet as JaxPCNet
from spaa_tpu.models.classifiers import normalize_imagenet as j_norm
from spaa_tpu.models.classifiers import unnormalize_imagenet as j_unnorm
from spaa_tpu_torch.models.classifiers import (normalize_imagenet,
                                               unnormalize_imagenet)
from spaa_tpu_torch.models.pcnet import PCNet
from spaa_tpu_torch.ops import color as TC
from spaa_tpu_torch.ops import metrics as TM
from spaa_tpu_torch.ops import tps as TT
from spaa_tpu_torch.utils import log as TL
from spaa_tpu_torch.utils import vis as TV
from spaa_tpu_torch.utils.imgproc_host import resize_linear_np
from spaa_tpu_torch.utils.seed import set_reproducibility
from spaa_tpu_torch.utils.sim_procams import DEFAULT_SIM_SETUP_INFO
from spaa_tpu_torch.utils.table import Table
from spaa_tpu_torch.weights import pcnet_state_dict

# spaa_tpu.ops re-exports the function ``tps`` under its module's name
JT = importlib.import_module("spaa_tpu.ops.tps")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = join(REPO, "checkpoint",
            "sim_setup_PCNet_l1+ssim_500_24_2000_0.001_0.2_800_0.0001.flax")


def _close(got, want, tol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ------------------------------------------------------------- item 9
@pytest.mark.parametrize("reduced", [False, True])
def test_tps_variants_match_spaa_tpu(reduced):
    rng = np.random.default_rng(1)
    n, t = 2, 9
    ctrl = rng.random((t, 2))
    theta = rng.normal(0, 0.1, (n, t + (2 if reduced else 3), 1))
    theta2 = rng.normal(0, 0.1, (n, t + (2 if reduced else 3), 2))
    grid = np.concatenate([np.ones((n, 5, 7, 1)), rng.random((n, 5, 7, 2))],
                          -1)
    xy = rng.random((6, 2))
    xy_n = rng.random((n, 6, 2))
    with enable_x64():
        want = [np.asarray(JT.tps_d(jnp.asarray(theta), jnp.asarray(ctrl),
                                    jnp.asarray(grid))),
                np.asarray(JT.tps_depth(jnp.asarray(theta), jnp.asarray(ctrl),
                                        (n, 3, 5, 7))),
                np.asarray(JT.tps_depth(jnp.asarray(theta), jnp.asarray(ctrl),
                                        (n, 4, 6))),
                np.asarray(JT.tps_sparse(jnp.asarray(theta2),
                                         jnp.asarray(ctrl), jnp.asarray(xy))),
                np.asarray(JT.tps_sparse(jnp.asarray(theta2),
                                         jnp.asarray(ctrl),
                                         jnp.asarray(xy_n)))]
    th, th2, c = (torch.from_numpy(a) for a in (theta, theta2, ctrl))
    got = [TT.tps_d(th, c, torch.from_numpy(grid)),
           TT.tps_depth(th, c, (n, 3, 5, 7)),
           TT.tps_depth(th, c, (n, 4, 6)),
           TT.tps_sparse(th2, c, torch.from_numpy(xy)),
           TT.tps_sparse(th2, c, torch.from_numpy(xy_n))]
    for g, w in zip(got, want):
        _close(g, w)


def test_rgb2xyz_l2_norm_to_mse_and_imagenet_normalisation():
    rng = np.random.default_rng(2)
    rgb = rng.random((2, 5, 6, 3))
    rgb[0, 0, :3] = [0.0, 0.0405, 0.04]           # both sRGB branches
    x = rng.normal(0, 1, (3, 4, 5, 3))
    with enable_x64():
        want = [np.asarray(JC.rgb2xyz(jnp.asarray(rgb))),
                np.asarray(JM.l2_norm_to_mse(jnp.asarray(x), 3)),
                np.asarray(j_norm(jnp.asarray(rgb))),
                np.asarray(j_unnorm(jnp.asarray(x)))]
    got = [TC.rgb2xyz(torch.from_numpy(rgb)),
           TM.l2_norm_to_mse(torch.from_numpy(x), 3),
           normalize_imagenet(torch.from_numpy(rgb)),
           unnormalize_imagenet(torch.from_numpy(x))]
    for g, w in zip(got, want):
        _close(g, w)
    # rgb2lab_diff goes through the same XYZ values
    lab = TC.rgb2lab_diff(torch.from_numpy(rgb))
    with enable_x64():
        _close(lab, np.asarray(JC.rgb2lab_diff(jnp.asarray(rgb))))
    _close(unnormalize_imagenet(normalize_imagenet(torch.from_numpy(rgb))),
           rgb, 1e-12)


def _values(table):
    if isinstance(table, Table):
        return table.columns, table.typed_rows()
    return list(table.columns), [list(r) for r in table.itertuples(
        index=False)]


def _same_values(got, want):
    gc, gr = _values(got)
    wc, wr = _values(want)
    assert gc == wc and len(gr) == len(wr)
    for g, w in zip(gr, wr):
        for a, b in zip(g, w):
            assert a == b or (isinstance(b, float) and np.isnan(b)
                              and a is None), (a, b)


def test_log_readers_and_setup_info_match_spaa_tpu(tmp_path):
    ret, txt, _ = JL.init_log_file(str(tmp_path / "jax"))
    ret.loc[0] = ["s", "PCNet", "l1+ssim", 500, 24, 2000,
                  30.0, 0.01, 0.99, 1.0, 0.5, 0.2]
    ret.loc[1] = ["t", "CompenNet++", "l1", 16, 8, 3,
                  21.94, 0.0812, 0.7, 2.5, 1.25, 3.0]
    JL.write_log_file(ret, txt, None)
    _same_values(TL.read_log(txt), JL.read_log(txt))

    table, txt2, _ = TL.init_log_file(str(tmp_path / "port"))
    table.append(["s", "PCNet", "l1+ssim", 500, 24, 2000,
                  30.0, 0.01, 0.99, 1.0, 0.5, float("nan")])
    TL.write_log_file(table, txt2, None)
    _same_values(TL.read_log(txt2), JL.read_log(txt2))

    old = tmp_path / "old_log.txt"
    old.write_text("Setup    Model  Loss    PSNR  Iters\n\n"
                   "  bunny  CompenNet  l1+ssim  28.125  1000\n"
                   "teddy\tCompenNet++   l1   -   2000\n")
    _same_values(TL.log_to_table(str(old)), JL.log_to_table(str(old)))

    cfg = dict(DEFAULT_SIM_SETUP_INFO)
    JL.export_setup_info(str(tmp_path / "jax_setup"), cfg)
    TL.export_setup_info(str(tmp_path / "port_setup"), cfg)
    want = (tmp_path / "jax_setup" / "setup_info.yml").read_bytes()
    assert (tmp_path / "port_setup" / "setup_info.yml").read_bytes() == want


def test_set_reproducibility_switches_determinism_only():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            set_reproducibility(True)
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.backends.cudnn.deterministic
            assert torch.backends.cudnn.benchmark is bench
            set_reproducibility(False)
            assert not torch.are_deterministic_algorithms_enabled()
            assert not torch.backends.cudnn.deterministic
            assert torch.backends.cudnn.benchmark is bench
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
        torch.backends.cudnn.benchmark = before[2]


@pytest.mark.parametrize("src_hw,dsize,chan", [
    ((17, 23), (40, 31), 3), ((256, 256), (320, 240), 3),
    ((48, 48), (256, 256), 3), ((40, 40), (20, 20), None),
    ((33, 50), (7, 9), None), ((6, 9), (9, 6), 1)])
def test_resize_linear_matches_cv2(src_hw, dsize, chan):
    import cv2
    rng = np.random.default_rng(sum(src_hw))
    shape = src_hw if chan is None else src_hw + (chan,)
    x = rng.random(shape).astype(np.float32)
    want = cv2.resize(x, dsize)
    got = resize_linear_np(x, dsize)
    if want.ndim < got.ndim:            # cv2 drops a single channel
        want = want[..., None]
    _close(got, want, 2e-7)


# ------------------------------------------------------------- item 10
class _Recorder:
    """Records every method call with its arguments."""

    def __init__(self, calls, *args, **kw):
        self._calls = calls
        calls.append(("__init__", args, kw))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def method(*args, **kw):
            self._calls.append((name, args, kw))
            return True if name == "check_connection" else name
        return method


def _fake_module(name, calls, attr):
    mod = types.ModuleType(name)
    setattr(mod, attr, lambda *a, **k: _Recorder(calls, *a, **k))
    return mod


def _same_calls(got, want, tol):
    assert [c[0] for c in got] == [c[0] for c in want]
    for (_, ga, gk), (_, wa, wk) in zip(got, want):
        assert len(ga) == len(wa) and sorted(gk) == sorted(wk)
        for g, w in list(zip(ga, wa)) + [(gk[k], wk[k]) for k in wk]:
            if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
                _close(np.asarray(g), np.asarray(w), tol)
            else:
                assert g == w


def _pcnets(cam_hw):
    """Both packages' PCNet on the committed checkpoint, in float64 (the
    warp's float32 grids differ by ~2.5e-5 between the libraries)."""
    with open(CKPT, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    net = PCNet(out_size=cam_hw)
    net.load_state_dict(pcnet_state_dict(params, np.float64))
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return net.double().eval(), JaxPCNet(out_size=cam_hw), params


def _drive(mod, cam_hw, net_args, inputs, log_path):
    """Every plotting entry point of one package, against a fake server."""
    assert mod.init_visdom() is not None
    rng = np.random.default_rng(8)
    batch = rng.random((3, 20, 22, 3)).astype(np.float32)
    mod.vfs(batch[0], title="one")
    mod.vfs(batch[:1])
    mod.vfs(batch, padding=4, title="three", ncol=2)
    mod.append_data_point(3, 0.5, win="w", name="n")
    mod.plot_montage(batch, batch[::-1], index=[0, 2], win="m", title="tt",
                     cp_sz=(10, 12))
    mod.plot_montage(batch[:2], grid_w=5)
    logger = mod.CurveLogger(log_path)
    logger.append(5, loss=0.25, psnr=20.0)
    logger.close()
    return mod.vis_pcnet_process(*net_args, *inputs)


def test_visdom_calls_and_pcnet_montage_match_spaa_tpu(tmp_path,
                                                       monkeypatch):
    cam_hw, prj_hw = (24, 32), (16, 16)
    net, jnet, params = _pcnets(cam_hw)
    rng = np.random.default_rng(0)
    mask = (rng.random((*cam_hw, 1)) > 0.2).astype(np.float64)
    scene = rng.random((1, *cam_hw, 3))
    prj = rng.random((1, *prj_hw, 3))
    train = rng.random((1, *cam_hw, 3))
    inputs = (prj, scene, train, mask)

    # offline: nothing is drawn, the montage is still returned
    monkeypatch.setattr(TV, "_vis", None)
    monkeypatch.setattr(JV, "_vis", None)
    assert TV.vfs(prj) is None and TV.plot_montage(prj) is None
    offline = TV.vis_pcnet_process(net, *inputs)

    calls = {"jax": [], "port": []}
    for key, mod, net_args in (("jax", JV, (jnet, params)),
                               ("port", TV, (net,))):
        monkeypatch.setitem(sys.modules, "visdom", _fake_module(
            "visdom", calls[key], "Visdom"))
        with enable_x64(key == "jax"):
            montage = _drive(mod, cam_hw, net_args, inputs,
                             str(tmp_path / f"{key}.jsonl"))
        calls[key + "_montage"] = np.asarray(montage)
    assert calls["port"][0] == ("__init__", (), dict(
        server="localhost", port=8097, use_incoming_socket=False))
    _same_calls(calls["port"], calls["jax"], 1e-5)
    assert calls["port_montage"].shape == (2 * 24 + 3 * 5, 4 * 32 + 5 * 5, 3)
    _close(calls["port_montage"], calls["jax_montage"], 1e-5)
    _close(offline, calls["port_montage"], 0)


def test_fs_matches_spaa_tpu_and_is_headless_safe(monkeypatch):
    im = np.random.default_rng(3).random((1, 6, 7, 1))
    calls = {}
    for key, mod in (("jax", JV), ("port", TV)):
        calls[key] = []
        pyplot = _fake_module("matplotlib.pyplot", calls[key], "figure")
        for name in ("imshow", "axis", "tight_layout", "title", "show"):
            setattr(pyplot, name, lambda *a, _n=name, _c=calls[key], **k:
                    _c.append((_n, a, k)))
        pkg = types.ModuleType("matplotlib")
        pkg.pyplot = pyplot
        monkeypatch.setitem(sys.modules, "matplotlib", pkg)
        monkeypatch.setitem(sys.modules, "matplotlib.pyplot", pyplot)
        mod.fs(im, title="x")
    _same_calls(calls["port"], calls["jax"], 0)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert TV.fs(im) is None
