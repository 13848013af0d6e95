"""Port parity (c): the fixed-grid warp of ``spaa_tpu_torch.ops.warp``
against ``spaa_tpu``'s Pallas warp (interpret mode on the CPU, as
tests/test_pallas_warp.py runs it), its ``jax.vjp`` and the reference
``grid_sample`` times the mask.

Tolerances: the request tables are compared exactly (same float32
weights); float32 warps sum the same four taps in a different order
(Pallas: spill rows) so they agree to 2e-6; float64 runs agree to 1e-12.
The kernel's band tables are decoded back to the CSR tables exactly. The
CUDA kernel itself is checked on the card (marker ``cuda``): max-abs 1e-5
against the plain version, float32 sums in another order. The launch
counter loses no increment under host threads.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from spaa_tpu.ops.image import grid_sample as jax_grid_sample
from spaa_tpu.ops.pallas.warp import _bilinear_requests, build_fixed_warp
from spaa_tpu.ops.pallas.warp import fixed_warp_apply as jax_fixed_warp_apply
from spaa_tpu_torch.ops import warp as W


def _wavy_grid(ho, wo, scale=0.9, rot_deg=2.0, wiggle=0.03,
               shift=(0.02, -0.01)):
    yy, xx = np.meshgrid(np.linspace(-1, 1, ho), np.linspace(-1, 1, wo),
                         indexing="ij")
    th = np.deg2rad(rot_deg)
    gx = scale * (np.cos(th) * xx - np.sin(th) * yy) \
        + wiggle * np.sin(3 * yy) + shift[0]
    gy = scale * (np.sin(th) * xx + np.cos(th) * yy) \
        + wiggle * np.cos(2 * xx) + shift[1]
    return np.stack([gx, gy], -1)[None].astype(np.float32)


def _mask(ho, wo):
    m = np.ones((ho, wo), np.float32)
    m[:3], m[:, -5:] = 0.0, 0.0
    m[ho // 2, : wo // 3] = 0.0
    return m


# (h, w, ho, wo), grid scale, folded mask: the shapes of
# tests/test_pallas_warp.py, its out-of-range grid, and a folded mask
CASES = [((32, 32, 24, 40), 0.9, False), ((64, 48, 40, 64), 0.9, False),
         ((16, 16, 16, 16), 1.6, False), ((32, 32, 24, 40), 0.9, True),
         ((16, 16, 16, 16), 1.6, True)]
IDS = ["32x32", "64x48", "out_of_range", "masked", "out_of_range_masked"]
# grids that leave the kernel's common path, with the grid's rotation:
# - rotated_90: each output row reads a source column, so every busy band's
#   window exceeds the staging budget in both passes;
# - rotated_45: backward bands both under and over the budget in one table;
# - zoom_in: source pixels with more backward taps than the kernel holds in
#   registers (remainder taps);
# - odd_width: rows that are not whole 16-byte units (nothing staged);
# - wide_odd_width: source rows of 517 px, so one-row backward bands of
#   1,551 floats, staged; at B = 132 each block of the backward handles
#   several images through its two shared-memory output buffers.
NEW_CASES = [((64, 64, 64, 64), 0.9, True, 90.0),
             ((64, 64, 64, 64), 0.9, True, 45.0),
             ((32, 32, 24, 40), 0.5, False, 2.0),
             ((19, 18, 15, 30), 0.9, False, 2.0),
             ((24, 517, 24, 520), 0.9, False, 2.0)]
NEW_IDS = ["rotated_90", "rotated_45", "zoom_in", "odd_width",
           "wide_odd_width"]
ALL_CASES, ALL_IDS = CASES + NEW_CASES, IDS + NEW_IDS
BY_ID = dict(zip(ALL_IDS, ALL_CASES))


def _setup(case, seed=0):
    (h, w, ho, wo), scale, masked = case[:3]
    rot = case[3] if len(case) > 3 else 2.0
    grid = _wavy_grid(ho, wo, scale=scale, rot_deg=rot)
    mask = _mask(ho, wo) if masked else None
    rng = np.random.default_rng(seed)
    im = rng.random((3, h, w, 3))
    cot = rng.standard_normal((3, ho, wo, 3))
    return grid, mask, im, cot


def _port(grid, mask, im, cot, dtype):
    warp = W.build_fixed_warp(torch.from_numpy(grid), im.shape[1:3],
                              dst_weight=mask, dtype=dtype)
    x = torch.tensor(im, dtype=dtype, requires_grad=True)
    out = W.fixed_warp_apply(warp, x)
    g, = torch.autograd.grad(out, x, torch.tensor(cot, dtype=dtype))
    return out.detach().numpy(), g.numpy()


def _jax_reference(grid, mask, im, cot, pallas: bool):
    """(out, grad) of spaa_tpu's warp in the input dtype."""
    m = 1.0 if mask is None else jnp.asarray(mask)[None, :, :, None]
    if pallas:
        spec, tables = build_fixed_warp(grid, im.shape[1:3], dst_weight=mask)
        fn = lambda x: jax_fixed_warp_apply(spec, tables, x)  # noqa: E731
    else:
        fn = lambda x: jax_grid_sample(x, jnp.asarray(grid)) * m  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(im))
    g, = vjp(jnp.asarray(cot, out.dtype))
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tables_equal_spaa_tpu_requests(case):
    """The CSR tables hold exactly spaa_tpu's request list (mask folded,
    zero-weight taps dropped), each row in grid_sample's tap order; the
    backward table is its transpose."""
    grid, mask, im, _ = _setup(case)
    h, w = im.shape[1:3]
    out_flat, src_flat, wgt = _bilinear_requests(grid[0], (h, w))
    if mask is not None:
        wgt = wgt * mask.reshape(-1)[out_flat]
        keep = wgt != 0.0
        out_flat, src_flat, wgt = out_flat[keep], src_flat[keep], wgt[keep]
    order = np.argsort(out_flat, kind="stable")
    warp = W.build_fixed_warp(grid, (h, w), dst_weight=mask)
    f = warp.fwd
    rows = np.repeat(np.arange(f.rows), np.diff(f.row_ptr.numpy()))
    np.testing.assert_array_equal(rows, out_flat[order])
    np.testing.assert_array_equal(f.col.numpy(), src_flat[order])
    np.testing.assert_array_equal(f.w.numpy(), wgt[order])
    b = warp.bwd
    brows = np.repeat(np.arange(b.rows), np.diff(b.row_ptr.numpy()))
    border = np.argsort(src_flat, kind="stable")
    np.testing.assert_array_equal(brows, src_flat[border])
    np.testing.assert_array_equal(b.col.numpy(), out_flat[border])
    np.testing.assert_array_equal(b.w.numpy(), wgt[border])


def _csr_rows(t: W.GatherTable):
    rp, col, w = t.row_ptr.numpy(), t.col.numpy(), t.w.numpy()
    return [(col[rp[r]:rp[r + 1]], w[rp[r]:rp[r + 1]]) for r in range(t.rows)]


def _check_band_table(t: W.GatherTable, width: int, in_row_px: int):
    """Decode every row's absolute (col, w) taps from the band tables and
    check them, the windows, modes and remainder flags against the CSR.
    A band stages its window when it fits the budget and input rows are
    whole 16-byte units."""
    b = t.bands
    band, seg = b.band.numpy(), b.seg.numpy()
    tap_off, tap_w = b.tap_off.numpy(), b.tap_w.numpy()
    rem_ptr, rem_off, rem_w = (b.rem_ptr.numpy(), b.rem_off.numpy(),
                               b.rem_w.numpy())
    csr = _csr_rows(t)
    assert b.n_bands == -(-t.rows // b.band_px)
    assert tap_off.shape[0] == b.n_bands * b.band_px == rem_ptr.size - 1
    if width <= b.band_px:
        assert b.band_px % width == 0          # bands of whole image rows
    staged_px = []
    for bi in range(b.n_bands):
        mode, s0, s1, win_px = band[bi]
        rows = range(bi * b.band_px, min((bi + 1) * b.band_px, t.rows))
        touched = np.unique(np.concatenate(
            [csr[r][0] // in_row_px for r in rows] + [np.zeros(0, int)]))
        window = np.concatenate(
            [np.arange(s // in_row_px, (s + n) // in_row_px)
             for s, n in seg[s0:s1]] + [np.zeros(0, int)])
        long_rows = any(csr[r][0].size > b.taps for r in rows)
        assert bool(mode & W.BAND_HAS_REMAINDER) == long_rows
        mode &= 3
        if touched.size == 0:
            assert mode == W.BAND_EMPTY and s0 == s1
        elif touched.size * in_row_px <= W.STAGE_BUDGET_PX \
                and in_row_px % 4 == 0:
            assert mode == W.BAND_STAGED
            np.testing.assert_array_equal(window, touched)
            assert win_px == touched.size * in_row_px
            assert (np.diff(seg[s0:s1, 0]) > 0).all()
            staged_px.append(win_px)
        else:
            assert mode == W.BAND_GLOBAL and s0 == s1 and win_px == 0
        for r in rows:
            n_ell = min(csr[r][0].size, b.taps)
            assert (tap_w[r, n_ell:] == 0).all()      # padding
            assert (tap_off[r, n_ell:] == 0).all()
            assert (tap_w[r, :n_ell] != 0).all()
            off = np.concatenate([tap_off[r, :n_ell],
                                  rem_off[rem_ptr[r]:rem_ptr[r + 1]]])
            w = np.concatenate([tap_w[r, :n_ell],
                                rem_w[rem_ptr[r]:rem_ptr[r + 1]]])
            if mode == W.BAND_STAGED:   # window origin + relative offset
                off = window[off // in_row_px] * in_row_px + off % in_row_px
            np.testing.assert_array_equal(off, csr[r][0])
            np.testing.assert_array_equal(w, csr[r][1])
    for r in range(t.rows, tap_off.shape[0]):   # rows padding the last band
        assert (tap_w[r] == 0).all() and rem_ptr[r + 1] == rem_ptr[r]
    assert b.stage_px == -(-max(staged_px, default=0) // 4) * 4
    assert b.n_busy == int(((band[:, 0] & 3) != W.BAND_EMPTY).sum())


@pytest.mark.parametrize("case", ALL_CASES, ids=ALL_IDS)
def test_band_tables_decode_to_csr(case):
    """The kernel's band tables hold exactly the CSR taps, in order: window
    origin + relative offset for staged bands, absolute offsets for bands
    over the staging budget, weight-0 padding, the remainder past the ELL
    width."""
    grid, mask, im, _ = _setup(case)
    h, w = im.shape[1:3]
    ho, wo = grid.shape[1:3]
    warp = W.build_fixed_warp(grid, (h, w), dst_weight=mask)
    _check_band_table(warp.fwd, wo, w)
    _check_band_table(warp.bwd, w, wo)
    fwd, bwd = (t.bands.band.numpy()[:, 0] for t in (warp.fwd, warp.bwd))
    busy = [m[(m & 3) != W.BAND_EMPTY] & 3 for m in (fwd, bwd)]
    if case is BY_ID["rotated_90"]:
        assert all((m == W.BAND_GLOBAL).all() for m in busy)
    if case is BY_ID["rotated_45"]:
        assert {W.BAND_STAGED, W.BAND_GLOBAL} <= set(busy[1].tolist())
    if case is BY_ID["zoom_in"]:
        assert (bwd & W.BAND_HAS_REMAINDER).any()
    if case is BY_ID["odd_width"]:
        assert all((m == W.BAND_GLOBAL).all() for m in busy)
    if case is BY_ID["wide_odd_width"]:
        assert (busy[1] == W.BAND_STAGED).all()
        assert warp.bwd.bands.band_px * 3 % 4 != 0
    if case is CASES[1]:    # the common path: every busy band staged
        assert all((m == W.BAND_STAGED).all() for m in busy)


@pytest.mark.parametrize("case", ALL_CASES, ids=ALL_IDS)
def test_plain_warp_matches_pallas_warp_and_its_vjp(case):
    grid, mask, im, cot = _setup(case)
    im, cot = im.astype(np.float32), cot.astype(np.float32)
    out, g = _port(grid, mask, im, cot, torch.float32)
    out_j, g_j = _jax_reference(grid, mask, im, cot, pallas=True)
    np.testing.assert_allclose(out, out_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(g, g_j, rtol=0, atol=2e-6)
    if case[1] > 1.0:   # corners fully out of range -> exactly zero
        assert out[0, 0, 0].max() == 0.0


@pytest.mark.parametrize("case", ALL_CASES, ids=ALL_IDS)
def test_plain_warp_matches_grid_sample_times_mask_f64(case):
    grid, mask, im, cot = _setup(case, seed=1)
    grid = grid.astype(np.float64)
    out, g = _port(grid, mask, im, cot, torch.float64)
    with enable_x64():
        out_j, g_j = _jax_reference(grid, mask, im, cot, pallas=False)
    np.testing.assert_allclose(out, out_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g, g_j, rtol=0, atol=1e-12)


def test_warp_output_is_nchw_memory_and_rejects_wrong_size():
    grid, mask, im, _ = _setup(CASES[0])
    warp = W.build_fixed_warp(grid, im.shape[1:3], dst_weight=mask)
    out = W.fixed_warp_apply(warp, torch.tensor(im, dtype=torch.float32))
    assert out.shape == (3, 24, 40, 3)
    assert out.permute(0, 3, 1, 2).is_contiguous()
    with pytest.raises(ValueError):
        W.fixed_warp_apply(warp, torch.zeros(1, 16, 16, 3))


def test_launch_counter_loses_no_increment_under_threads():
    """8 host threads x 10,000 increments through ``count_launch`` (the
    multi-setup paths launch from one host thread per card) count
    exactly 80,000. The key hashes in Python and the switch interval is
    shortened, so that an unlocked ``+=`` can lose the interpreter lock
    between its read and its write."""
    class Key(str):
        def __hash__(self):
            return str.__hash__(self)

    key = Key("fixed_warp_bwd")

    def work():
        for _ in range(10_000):
            W.count_launch(key)

    W.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert W.LAUNCHES == {"fixed_warp_fwd": 0, "fixed_warp_bwd": 80_000}
    W.reset_launch_counts()
    assert W.LAUNCHES == {"fixed_warp_fwd": 0, "fixed_warp_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5, 132])
@pytest.mark.parametrize("case", ALL_CASES, ids=ALL_IDS)
def test_kernel_matches_plain_version_on_cuda(case, batch):
    """On the card: the kernel against the plain version, forward and
    backward, at small shapes, staged and over-budget bands; run-to-run
    bitwise identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    grid, mask, _, _ = _setup(case)
    (h, w, ho, wo) = case[0]
    rng = np.random.default_rng(batch)
    im, cot = rng.random((batch, h, w, 3)), rng.standard_normal(
        (batch, ho, wo, 3))
    warp_cpu = W.build_fixed_warp(grid, (h, w), dst_weight=mask)
    warp = W.build_fixed_warp(grid, (h, w), dst_weight=mask, device="cuda")
    x = torch.tensor(im, dtype=torch.float32)
    d = torch.tensor(cot, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()
    before = dict(W.LAUNCHES)
    outs = [W.warp_forward(warp, x.cuda()) for _ in range(2)]
    grads = [W.warp_backward(warp, d.cuda()) for _ in range(2)]
    torch.cuda.synchronize()
    assert W.LAUNCHES["fixed_warp_fwd"] == before["fixed_warp_fwd"] + 2
    assert W.LAUNCHES["fixed_warp_bwd"] == before["fixed_warp_bwd"] + 2
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    torch.testing.assert_close(outs[0].cpu(), W.warp_forward(warp_cpu, x),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(grads[0].cpu(), W.warp_backward(warp_cpu, d),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernel_takes_misaligned_input_on_cuda():
    """A contiguous input that does not start on a 16-byte boundary gives
    the same result as an aligned one, in both passes of a staged table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    grid, mask, im, cot = _setup(CASES[1])
    warp = W.build_fixed_warp(grid, im.shape[1:3], dst_weight=mask,
                              device="cuda")
    assert warp.fwd.bands.stage_px and warp.bwd.bands.stage_px
    x = torch.tensor(im, dtype=torch.float32, device="cuda")
    d = torch.tensor(cot, dtype=torch.float32,
                     device="cuda").permute(0, 3, 1, 2).contiguous()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device="cuda")
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    assert torch.equal(W.warp_forward(warp, shifted(x)),
                       W.warp_forward(warp, x))
    assert torch.equal(W.warp_backward(warp, shifted(d)),
                       W.warp_backward(warp, d))


@pytest.mark.cuda
def test_kernels_use_no_local_memory_on_cuda():
    """Neither kernel spills registers or keeps a stack frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    for backward in (False, True):
        assert W.kernel_attrs(backward)["local_bytes"] == 0
