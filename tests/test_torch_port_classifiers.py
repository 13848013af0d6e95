"""Port parity: VGG-16 and Inception-v3.

- logits and their input gradient through the classify pipeline (crop
  240x240 from 240x320, 'area' resize to 224 / 299, normalise) against
  ``spaa_tpu``'s ``make_logits_fn``, float64, B = 2, <=1e-6. The weights
  are the port's seeded init (BatchNorm statistics randomised), taken to
  ``spaa_tpu`` by its own torchvision converter and back by the port's
  bridge, which must return them unchanged;
- a torchvision-named ``.pth`` loads as it is (Inception's ``AuxLogits``
  and ``num_batches_tracked`` keys dropped); random init is deterministic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from spaa_tpu.models.classifiers import make_logits_fn as jax_make_logits_fn
from spaa_tpu.models.classifiers.convert import convert_state_dict
from spaa_tpu_torch.models.classifiers import (Classifier, build_classifier,
                                               make_logits_fn)
from spaa_tpu_torch.models.classifiers.inception import InceptionV3
from spaa_tpu_torch.models.classifiers.resnet import EvalBatchNorm
from spaa_tpu_torch.models.classifiers.vgg import VGG16
from spaa_tpu_torch.weights import inception_v3_state_dict, vgg16_state_dict

CROP = (240, 240)
MODELS = {"vgg16": (VGG16, vgg16_state_dict),
          "inception_v3": (InceptionV3, inception_v3_state_dict)}


def _seeded(cls, seed):
    net = cls().init_weights(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, EvalBatchNorm):
                c = m.weight.shape
                m.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(1.0 + 0.5 * torch.rand(c, generator=gen))
    return net


@pytest.mark.parametrize("name", ["vgg16", "inception_v3"])
def test_logits_and_input_gradient_match_f64(name):
    cls, bridge = MODELS[name]
    sd = _seeded(cls, 1).state_dict()
    params = convert_state_dict(name, sd)          # spaa_tpu's converter
    back = bridge(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    rng = np.random.default_rng(2)
    im = rng.uniform(0, 1, (2, 240, 320, 3))
    cot = rng.standard_normal((2, 1000))
    with enable_x64():
        fn = jax_make_logits_fn(name)
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           params)

        @jax.jit
        def fwd_vjp(p, x, c):
            raw, vjp = jax.vjp(lambda x: fn(p, x, CROP), x)
            return raw, vjp(c)[0]

        raw_j, g_j = (np.asarray(a) for a in fwd_vjp(p64, jnp.asarray(im),
                                                     jnp.asarray(cot)))
    net = cls()
    net.load_state_dict(bridge(params, np.float64))
    net = net.double().eval()
    x = torch.tensor(im, requires_grad=True)
    raw_t = make_logits_fn(net, CROP)(x)
    g_t, = torch.autograd.grad(raw_t, x, torch.tensor(cot))
    assert np.abs(raw_j).max() > 0.1            # not a vanishing network
    np.testing.assert_allclose(raw_t.detach().numpy(), raw_j, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,fname", [
    ("vgg16", "vgg16-397923af.pth"),
    ("inception_v3", "inception_v3_google-0cc3c7bd.pth")])
def test_pth_loads_as_is_and_random_init_is_deterministic(tmp_path, name,
                                                          fname):
    cls, _ = MODELS[name]
    ref = _seeded(cls, 3)
    sd = dict(ref.state_dict())
    if name == "inception_v3":      # torchvision's file carries these too
        sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
        sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    torch.save(sd, tmp_path / fname)
    clf = Classifier(name, str(tmp_path), device="cpu")
    assert clf.params_source == "pth" and clf.loaded_pretrained
    assert clf.input_sz == cls.input_size
    im = torch.rand(1, 240, 320, 3, generator=torch.Generator().manual_seed(0))
    raw, p, idx = clf(im)
    with torch.no_grad():
        np.testing.assert_array_equal(raw.numpy(),
                                      make_logits_fn(ref.eval())(im).numpy())
    assert idx[0, 0] == int(raw.argmax()) and abs(p[0].sum() - 1) < 1e-5
    assert all(not q.requires_grad for q in clf.net.parameters())

    a, src_a = build_classifier(name, str(tmp_path / "none"), seed=1,
                                device="cpu")
    b, src_b = build_classifier(name, str(tmp_path / "none"), seed=1,
                                device="cpu")
    assert src_a == src_b == "random"
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
