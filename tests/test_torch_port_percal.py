"""Port parity: the PerC-AL attack against ``spaa_tpu``.

Float64 trajectories of ``_percal_body`` against
``spaa_tpu.attack.perc_al._percal_step_jit``, 5 iterations, every state
(delta, col_best, x_best) after every iteration <=1e-5 and every mask
equal (the pattern of tests/test_attack_trajectory_oracle.py:410-455):

- the fused projector batch of ``perc_al_compennet_pp`` (2 targeted + 1
  untargeted, confidence 40, which applies to the untargeted sample only);
- the digital ``adversary`` (``projector_variant=False``), targeted and
  untargeted, on inputs that differ per sample: one label the clean
  prediction (cross-entropy steps), one another class (adversarial from
  the start: colour steps).

ResNet-18 carries ``spaa_tpu``'s ``init_params`` with a 64x64 input, to
keep float64 cheap. Also: the cosine step sizes, 8-bit quantisation (half
to even), the class API's range check and ``perc_al_core``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from spaa_tpu.attack.perc_al import PercALConfig as JaxPercALConfig
from spaa_tpu.attack.perc_al import _percal_step_jit
from spaa_tpu.attack.perc_al import quantization as jax_quantization
from spaa_tpu.models.classifiers import init_params
from spaa_tpu.models.classifiers.resnet import ResNet18 as JaxResNet18
from spaa_tpu.ops.color import rgb2lab_diff as jax_rgb2lab
from spaa_tpu.ops.image import center_crop, resize_area
from spaa_tpu_torch.attack.perc_al import (PerC_AL, PercALConfig,
                                           _percal_body, _step_sizes,
                                           perc_al_core, quantization)
from spaa_tpu_torch.models.classifiers import make_logits_fn
from spaa_tpu_torch.models.classifiers.resnet import ResNet18
from spaa_tpu_torch.ops.color import rgb2lab_diff
from spaa_tpu_torch.weights import resnet18_state_dict

CAM_HW, CP_SZ, NET_SZ = (48, 64), (40, 40), (64, 64)
MEAN = np.array([0.485, 0.456, 0.406])
STD = np.array([0.229, 0.224, 0.225])
ITERS = 5


@pytest.fixture(scope="module")
def world():
    params = jax.tree.map(np.asarray, init_params("resnet18", seed=0))
    net = ResNet18()
    net.load_state_dict(resnet18_state_dict(params, np.float64))
    net = net.double().eval().requires_grad_(False)
    net.input_size = NET_SZ
    j_net = JaxResNet18()

    def j_logits(cp, im):
        x = resize_area(center_crop(im, CP_SZ), NET_SZ)
        return j_net.apply({"params": cp},
                           (x - jnp.asarray(MEAN)) / jnp.asarray(STD))

    return dict(params=params, t_logits=make_logits_fn(net, CP_SZ),
                j_logits=j_logits)


def _trajectories(world, inputs, labels, targeted, cfg_kw, d_thr,
                  projector_variant):
    """Both packages' states after each of ITERS iterations."""
    b = inputs.shape[0]
    with enable_x64():
        cp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          world["params"])
        x = jnp.asarray(inputs)
        cfg = JaxPercALConfig(max_iterations=ITERS, **cfg_kw)
        state = (jnp.zeros_like(x), jnp.zeros((b,), bool),
                 jnp.full((b,), 1e5, jnp.float64), x)
        lab = jax_rgb2lab(x)
        traj_j = []
        for it in range(ITERS):
            state = _percal_step_jit(
                world["j_logits"], cp, x, lab, jnp.asarray(labels, jnp.int32),
                jnp.asarray(targeted), cfg, jnp.full((b,), d_thr),
                projector_variant, jnp.asarray(it, jnp.int32), state)
            traj_j.append([np.asarray(s) for s in state])

    x_t = torch.tensor(inputs)
    state_t = (torch.zeros_like(x_t), torch.zeros(b, dtype=torch.bool),
               torch.full((b,), 1e5, dtype=torch.float64), x_t)
    cfg_t = PercALConfig(max_iterations=ITERS, **cfg_kw)
    traj_t = []
    for it in range(ITERS):
        state_t = _percal_body(
            world["t_logits"], x_t, rgb2lab_diff(x_t), torch.tensor(labels),
            torch.tensor(targeted), cfg_t,
            torch.full((b,), d_thr, dtype=torch.float64), projector_variant,
            it, state_t)
        traj_t.append([s.numpy() for s in state_t])
    return traj_j, traj_t


def _assert_same(traj_j, traj_t):
    for it, (sj, st) in enumerate(zip(traj_j, traj_t)):
        for name, a, b in zip(("delta", "mask_adv", "col_best", "x_best"),
                              sj, st):
            if name == "mask_adv":
                np.testing.assert_array_equal(b, a, err_msg=f"iter {it}")
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                           err_msg=f"iter {it} {name}")


def _true_idx(world, scene):
    with torch.no_grad():
        return int(torch.argmax(world["t_logits"](torch.tensor(scene))[0]))


def test_fused_projector_batch_matches_spaa_tpu_f64(world):
    rng = np.random.default_rng(21)
    scene = rng.uniform(0.05, 0.95, (1, *CAM_HW, 3))
    inputs = np.broadcast_to(scene, (3, *CAM_HW, 3)).copy()
    labels = np.asarray([3, 14, _true_idx(world, scene)])
    traj_j, traj_t = _trajectories(
        world, inputs, labels, np.asarray([True, True, False]),
        dict(alpha_l_init=1.0, alpha_c_init=0.5, confidence=40.0), 5.0, True)
    _assert_same(traj_j, traj_t)
    assert np.abs(traj_t[-1][0]).max() > 1e-3      # the attack moved


@pytest.mark.parametrize("targeted", [True, False])
def test_digital_adversary_matches_spaa_tpu_f64(world, targeted):
    rng = np.random.default_rng(22)
    inputs = rng.uniform(0.05, 0.95, (2, *CAM_HW, 3))
    top = [_true_idx(world, inputs[k:k + 1]) for k in range(2)]
    # targeted: sample 1 already is its target; untargeted: sample 1's
    # label is not its prediction, so it is adversarial from the start
    labels = np.asarray([(top[0] + 7) % 1000 if targeted else top[0],
                         top[1] if targeted else (top[1] + 7) % 1000])
    traj_j, traj_t = _trajectories(
        world, inputs, labels, np.asarray([targeted] * 2),
        dict(alpha_l_init=1.0, alpha_c_init=0.5, confidence=0.0), 0.0, False)
    _assert_same(traj_j, traj_t)
    masks = np.stack([s[1] for s in traj_t])
    assert masks[:, 1].all()             # colour steps throughout
    if targeted:                         # cross-entropy steps throughout
        assert not masks[:, 0].any()


def test_step_sizes_quantization_and_class_api(world):
    for i in (0, 1, 17, 49):
        with enable_x64():
            fi = jnp.asarray(i, jnp.int32).astype(jnp.float32)
            cos = 1.0 + jnp.cos(fi / 50 * jnp.pi)
            want = (0.01 + 0.5 * (1.0 - 0.01) * cos,
                    0.05 + 0.5 * (0.5 - 0.05) * cos)
        got = _step_sizes(i, PercALConfig(max_iterations=50))
        for g, w in zip(got, want):
            assert abs(g - float(w)) <= 1e-7 * float(w)
    x = np.asarray([0.5, 1.5, 2.5, 3.5, 254.5, 10.2], np.float32) / 255.0
    np.testing.assert_array_equal(quantization(torch.tensor(x)).numpy(),
                                  np.asarray(jax_quantization(jnp.asarray(x))))
    rng = np.random.default_rng(23)
    # 8-bit inputs: the best images, initial or found, are all 8-bit
    inputs = quantization(torch.tensor(rng.uniform(0.05, 0.95,
                                                   (2, *CAM_HW, 3))))
    atk = PerC_AL(max_iterations=2)
    out = atk.adversary(world["t_logits"], inputs, [3, 14], targeted=True)
    want = perc_al_core(world["t_logits"], inputs, torch.tensor([3, 14]),
                        True, atk.cfg)
    assert torch.equal(out, want) and out.shape == inputs.shape
    assert torch.equal(out, quantization(out))
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        atk.adversary_projector(world["t_logits"], inputs + 1.0, [3, 14])
