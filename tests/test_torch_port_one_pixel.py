"""Port parity: One-pixel DE against ``spaa_tpu`` on the CPU.

- ``BatchedDE``: the same seed and fitness (a quadratic, Rosenbrock-5)
  give the same population, trials and energies at every generation, and
  the same early stop (pure numpy: equal bit for bit); the scipy
  calibration of tests/test_attacks.py passes on the port's solver;
- ``perturb_image_np`` and the batched perturb equal ``spaa_tpu``'s on
  random populations, blocks at all four borders, colours at ``k + 0.5``
  and coordinates at ``k - 1e-9`` included (the float32 cast before the
  rounding and truncation, and the clamp of ``dynamic_update_slice``);
- both attackers, given float64 stand-in classifiers that compute the
  same function in each package (and, for the projector attacker, the
  same capture callable), find the same ``best_x``, image and table, with
  the same number of captures and no defensive fallback.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from spaa_tpu.attack import one_pixel as J
from spaa_tpu_torch.attack import one_pixel as T
from spaa_tpu_torch.ops.image import center_crop


def _sphere(pop):
    return np.sum((np.asarray(pop, np.float64) - 0.7) ** 2, axis=-1)


def _rosenbrock(pop):
    p = np.asarray(pop, np.float64)
    return np.sum(100 * (p[..., 1:] - p[..., :-1] ** 2) ** 2
                  + (1 - p[..., :-1]) ** 2, axis=-1)


def _run_de(mod, fitness, bounds, popsize, maxiter, seed, stop_below):
    calls, bests = [], []

    def recorded(pop):
        e = fitness(pop)
        calls.append((np.array(pop), np.array(e)))
        return e

    def callback(best_x):
        bests.append(np.array(best_x))
        return bool(fitness(best_x[None])[0] < stop_below)

    best, energy = mod.BatchedDE(recorded, bounds, popsize=popsize,
                                 maxiter=maxiter, seed=seed,
                                 callback=callback).solve()
    return calls, bests, best, energy


@pytest.mark.parametrize("fitness,bounds,popsize,maxiter,stop_below", [
    (_sphere, [(-5, 5)] * 3, 15, 40, 0.05),
    (_rosenbrock, [(-2, 2)] * 5, 40, 60, -1.0),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_batched_de_trajectory_equals_spaa_tpu(fitness, bounds, popsize,
                                               maxiter, stop_below, seed):
    want = _run_de(J, fitness, bounds, popsize, maxiter, seed, stop_below)
    got = _run_de(T, fitness, bounds, popsize, maxiter, seed, stop_below)
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    for (gp, ge), (wp, we) in zip(got[0], want[0]):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(ge, we)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]
    if stop_below > 0:                 # the callback ended it early
        assert len(want[0]) < maxiter + 1


def _rastrigin(pop):
    p = np.asarray(pop, np.float64)
    return 10 * p.shape[-1] + np.sum(p ** 2 - 10 * np.cos(2 * np.pi * p),
                                     axis=-1)


def _imgfit_factory():
    rng0 = np.random.default_rng(99)
    base_im = rng0.random((16, 16, 3))
    readout = rng0.normal(0, 1.0, (16 * 16 * 3,))

    def imgfit(pop):
        p = np.atleast_2d(np.asarray(pop, np.float64))
        out = np.empty(p.shape[0])
        for i, x in enumerate(p):
            im = base_im.copy()
            im[int(x[0]), int(x[1])] = x[2:5] / 255.0
            out[i] = 1.0 / (1.0 + np.exp(-(im.ravel() @ readout) * 0.05))
        return out
    return imgfit


@pytest.mark.parametrize("name,f,bounds,maxiter,popmul,atol,floor", [
    ("sphere10", lambda p: np.sum(np.asarray(p, np.float64) ** 2, axis=-1),
     [(-5, 5)] * 10, 250, 4, 0.5, 2.5),
    ("rastrigin5", _rastrigin, [(-5.12, 5.12)] * 5, 250, 8, 2.0, 15.0),
    ("rosenbrock5", _rosenbrock, [(-2, 2)] * 5, 400, 8, 0.1, 4.5),
    ("imgfit", _imgfit_factory(),
     [(0, 15), (0, 15), (0, 255), (0, 255), (0, 255)], 75, 8, 0.005, 0.51),
])
def test_batched_de_matches_scipy_de(name, f, bounds, maxiter, popmul, atol,
                                     floor):
    """tests/test_attacks.py::test_batched_de_matches_scipy_de on the
    port's solver: the median best energy over 4 seeds within 1.5x + atol
    of scipy's ``differential_evolution`` at the same budget (best1bin,
    recombination 1, dithered mutation, no polish), and under a floor."""
    from scipy.optimize import differential_evolution
    npop = popmul * len(bounds)
    scipy_e, batched_e = [], []
    for seed in range(4):
        res = differential_evolution(
            lambda x: float(f(x[None])[0]), bounds, maxiter=maxiter,
            popsize=popmul, recombination=1, atol=-1, polish=False,
            seed=seed, tol=-1)
        scipy_e.append(res.fun)
        _, be = T.BatchedDE(f, bounds, popsize=npop, maxiter=maxiter,
                            seed=seed).solve()
        batched_e.append(be)
    med_s, med_b = float(np.median(scipy_e)), float(np.median(batched_e))
    assert med_b <= med_s * 1.5 + atol, (name, med_b, med_s)
    assert med_b <= floor, (name, med_b)


def _population(rng, n, h, w, d):
    """Random [n, 10] populations (two blocks each) inside the DE bounds,
    with blocks at the four borders, colours at k + 0.5 and coordinates at
    k - 1e-9."""
    lo = np.array([d, d, 0, 0, 0] * 2, np.float64)
    hi = np.array([h - 1 - d, w - 1 - d, 255, 255, 255] * 2, np.float64)
    pop = lo + rng.random((n, 10)) * (hi - lo)
    pop[0, :2] = [d, d]                        # top-left
    pop[1, :2] = [h - 1 - d, w - 1 - d]        # bottom-right
    pop[2, :2] = [d, w - 1 - d]                # top-right
    pop[3, :2] = [h - 1 - d, d]                # bottom-left
    pop[4, 5:7] = [d + 0.999, h - 1 - d]
    pop[5:9, 2:5] = np.floor(pop[5:9, 2:5]) + 0.5       # round half to even
    pop[9:13, :2] = np.ceil(pop[9:13, :2]) - 1e-9       # float32 rounds up
    pop[13, 5:10] = [h - 1 - d - 1e-9, d + 1e-9, 254.5, 0.5, 1.5]
    return pop


@pytest.mark.parametrize("pixel_size", [1, 5, 9])
def test_perturbs_equal_spaa_tpu(pixel_size):
    rng = np.random.default_rng(pixel_size)
    h, w, d = 24, 31, pixel_size // 2
    im = rng.random((h, w, 3)).astype(np.float32)
    pop = _population(rng, 40, h, w, d)
    for x in pop:
        np.testing.assert_array_equal(
            T.perturb_image_np(x, im, pixel_size),
            J.perturb_image_np(x, im, pixel_size))
    want = np.asarray(J._make_batched_perturb(pixel_size)(
        jnp.asarray(im), jnp.asarray(pop)))
    got = T._make_batched_perturb(pixel_size)(torch.from_numpy(im), pop)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the float32 cast changes what float64 truncation would give
    assert int(np.float32(pop[9, 0])) == int(np.ceil(pop[9, 0]))


# --------------------------------------------------------------- attackers
_A = np.random.default_rng(17).normal(0, 1, (6, 8))
CP_SZ = (12, 14)


def _jax_logits(im, dtype):
    im = jnp.asarray(im, dtype)
    if im.ndim == 3:
        im = im[None]
    h, w = im.shape[1:3]
    i, j = round((h - CP_SZ[0]) / 2), round((w - CP_SZ[1]) / 2)
    c = im[:, i:i + CP_SZ[0], j:j + CP_SZ[1]]
    f = jnp.concatenate([c.mean(axis=(1, 2)), (c * c).mean(axis=(1, 2))], 1)
    return 12.0 * f @ jnp.asarray(_A, im.dtype)


def _torch_logits(im, dtype=torch.float32):
    im = torch.as_tensor(im).to(dtype)
    if im.ndim == 3:
        im = im[None]
    c = center_crop(im, CP_SZ)
    f = torch.cat([c.mean(dim=(1, 2)), (c * c).mean(dim=(1, 2))], 1)
    return 12.0 * f @ torch.from_numpy(_A).to(im.dtype)


class JaxStandIn:
    """``spaa_tpu``'s classifier interface on a function of the centre
    crop, computed in ``dtype``."""
    name = "standin"
    params = None

    def __init__(self, dtype=jnp.float32):
        self.dtype = dtype
        self.calls = []

    def _logits_fn(self, params, im, crop_sz):
        return _jax_logits(im, self.dtype)

    def __call__(self, im, crop_sz):
        self.calls.append(np.shape(im))
        raw = _jax_logits(im, self.dtype)
        p = np.asarray(jax.nn.softmax(raw, axis=1))
        return raw, p, np.argsort(-p, axis=1)


class TorchStandIn:
    """The port's classifier interface on the same function."""
    name = "standin"
    device = torch.device("cpu")

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype
        self.calls = []

    def logits(self, im, crop_sz):
        return _torch_logits(im, self.dtype)

    def __call__(self, im, crop_sz):
        self.calls.append(tuple(np.shape(im)))
        raw = _torch_logits(im, self.dtype)
        p = torch.softmax(raw, 1).numpy()
        return raw, p, np.argsort(-p, axis=1)


def _same_table(got, want):
    assert got.columns == list(want.columns) == T.RESULT_COLUMNS
    row = want.iloc[0]
    for c, v in zip(got.columns, got.rows[0]):
        if c in ("true_p", "pred_p", "cdiff"):
            assert abs(v - float(row[c])) <= 1e-6, c
        else:
            assert v == row[c], c


@pytest.mark.parametrize("targeted,target", [(True, 3), (False, None)])
def test_digital_attacker_equals_spaa_tpu(targeted, target):
    """In float32: ``spaa_tpu``'s digital perturb cannot trace with 64-bit
    mode on (its ``dynamic_update_slice`` start mixes int32 and int64)."""
    rng = np.random.default_rng(4)
    im = (0.3 + 0.4 * rng.random((20, 22, 3))).astype(np.float32)
    if target is None:        # untargeted: away from the clean prediction
        target = int(_torch_logits(im).argmax())
    kw = dict(targeted_attack=targeted, target_idx=target, pixel_count=1,
              pixel_size=7, maxiter=6, popsize=30)
    names = {i: f"c{i}" for i in range(8)}
    j_atk = J.DigitalOnePixelAttacker(names, CP_SZ)
    want_table, want_im = j_atk.attack(jnp.asarray(im), JaxStandIn(), **kw)
    want_im = np.asarray(want_im)
    clf = TorchStandIn()
    atk = T.DigitalOnePixelAttacker(names, CP_SZ)
    got_table, got_im = atk.attack(torch.from_numpy(im), clf, **kw)
    assert got_im.dtype == torch.float32
    np.testing.assert_array_equal(got_im.numpy(), want_im)
    _same_table(got_table, want_table)
    assert atk.cache_misses == 0
    assert clf.calls == [(2, 20, 22, 3)]          # only the final classify


class CountingCapture:
    """A deterministic stand-in for ProCams: the projector image shrunk,
    tinted and lit on a fixed surface; counts its captures."""

    def __init__(self):
        self.surface = np.random.default_rng(5).random((16, 20, 3))
        self.n = 0

    def capture(self, prj_im):
        self.n += 1
        small = prj_im[::2, ::2][:16, :20]
        cam = 0.1 + self.surface * (0.2 + 0.7 * small[..., ::-1])
        return np.clip(cam, 0, 1).astype(np.float32)


@pytest.mark.parametrize("targeted,target", [(True, 5), (False, None)])
def test_projector_attacker_equals_spaa_tpu(targeted, target):
    """The stand-ins classify in float64; the captures are float32."""
    sinfo = {"classifier_crop_sz": list(CP_SZ)}
    prj = np.full((32, 40, 3), 0.5, np.float32)
    cam_org = CountingCapture().capture(prj)
    if target is None:
        target = int(_torch_logits(center_crop(
            torch.from_numpy(cam_org)[None], CP_SZ)).argmax())
    kw = dict(targeted_attack=targeted, target_idx=target, pixel_count=1,
              pixel_size=9, maxiter=5, popsize=20, true_label="x")
    names = {i: f"c{i}" for i in range(8)}
    with enable_x64():
        j_cap = CountingCapture()
        j_atk = J.ProjectorOnePixelAttacker(names, sinfo, j_cap)
        j_atk.im_cam_org = cam_org
        want_table, want_prj, want_cam = j_atk.attack(
            prj, JaxStandIn(jnp.float64), **kw)
    cap = CountingCapture()
    atk = T.ProjectorOnePixelAttacker(names, sinfo, cap)
    atk.im_cam_org = cam_org
    clf = TorchStandIn(torch.float64)
    got_table, got_prj, got_cam = atk.attack(prj, clf, **kw)
    np.testing.assert_array_equal(got_prj, want_prj)
    np.testing.assert_array_equal(got_cam, want_cam)
    _same_table(got_table, want_table)
    assert cap.n == j_cap.n and atk.cache_misses == 0
    # one batch per generation (npop = 20 // 5 * 5), then the final pair
    assert clf.calls[0] == (20, 16, 20, 3) and clf.calls[-1] == (2,) + CP_SZ \
        + (3,)
    assert cap.n == 20 * (len(clf.calls) - 1) + 1
