"""Bilinear warp over a FIXED sampling grid: CUDA kernel and plain version.

Counterpart of ``spaa_tpu/ops/pallas/warp.py``. The attack's PCNet warps
every projector image with the same baked grid, so the warp is a constant
sparse matrix with at most four taps per output pixel (torch
``grid_sample`` semantics: ``align_corners=True``, zeros padding, taps
outside the image dropped). :func:`build_fixed_warp` builds it on the host
from the same request list as ``spaa_tpu``'s ``_bilinear_requests`` as two
CSR tables, the forward one and its transpose, and
:func:`fixed_warp_apply` applies it with autograd.

On a CUDA tensor the forward and the backward launch the hand-written
kernel ``csrc/fixed_warp.cu`` (float32 only) or raise; on a CPU tensor they
run the plain PyTorch version below (index gather and weighted sum over a
padded copy of the same tables), which is also what the kernel is checked
against on the card. The TPU packing tables (one-hot MXU row fetch,
128-lane gather, spill rows) are a TPU artefact and are not carried over.

Layouts: the forward reads NHWC ``[N, H, W, C]`` and writes NCHW
``[N, C, Ho, Wo]``; the backward reads the NCHW cotangent and writes the
NHWC gradient. :func:`fixed_warp_apply` returns an NHWC view of the NCHW
result, so the shading CNN gets its NCHW input with no copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

# launches of each kernel since the last reset_launch_counts(): incremented
# by the wrappers right where they launch, nowhere else. One lock guards
# every write: the multi-setup paths launch from one host thread per card.
LAUNCHES = {"fixed_warp_fwd": 0, "fixed_warp_bwd": 0}
_LAUNCHES_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to :data:`LAUNCHES`."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _bilinear_requests(grid_np: np.ndarray, src_hw: Tuple[int, int]):
    """[Ho, Wo, 2] normalised grid -> bilinear requests (out_flat,
    src_flat, w) with torch grid_sample semantics (align_corners=True,
    zeros padding); w in float64. Taps are listed (y0,x0), (y0,x1),
    (y1,x0), (y1,x1), the order grid_sample sums them in."""
    h, w = src_hw
    x = (grid_np[..., 0].astype(np.float64) + 1.0) * 0.5 * (w - 1)
    y = (grid_np[..., 1].astype(np.float64) + 1.0) * 0.5 * (h - 1)
    x0, y0 = np.floor(x), np.floor(y)
    wx1, wy1 = x - x0, y - y0
    out_flat = np.arange(x.size)
    reqs = []
    for dy, wy in ((0.0, 1.0 - wy1), (1.0, wy1)):
        for dx, wx in ((0.0, 1.0 - wx1), (1.0, wx1)):
            yt, xt = y0 + dy, x0 + dx
            valid = (yt >= 0) & (yt <= h - 1) & (xt >= 0) & (xt <= w - 1)
            wgt = (wy * wx * valid).ravel()
            keep = wgt != 0.0
            ytc = np.clip(yt, 0, h - 1).astype(np.int64).ravel()[keep]
            xtc = np.clip(xt, 0, w - 1).astype(np.int64).ravel()[keep]
            reqs.append((out_flat[keep], ytc * w + xtc, wgt[keep]))
    return tuple(np.concatenate([r[i] for r in reqs]) for i in range(3))


BAND_EMPTY, BAND_STAGED, BAND_GLOBAL, BAND_HAS_REMAINDER = 0, 1, 2, 4
# a staged window holds at most this many pixels: 32 KB at 3 float channels;
# a band whose window is wider gathers from device memory
STAGE_BUDGET_PX = 32 * 1024 // (3 * 4)
# pixels per band and taps in registers of each kernel (csrc/fixed_warp.cu:
# forward 256 threads x 5 pixels, backward 512 threads x 2 pixels)
FWD_BAND_CAPACITY, FWD_TAPS = 1280, 4
BWD_BAND_CAPACITY, BWD_TAPS = 1024, 6


@dataclasses.dataclass(frozen=True)
class BandTable:
    """The kernel's form of one GatherTable.

    Table rows are cut into bands of ``band_px`` rows (whole image rows
    where they fit the kernel's capacity). A band's taps read a window of
    input image rows (``in_row_px`` pixels each), listed as segments (runs
    of consecutive rows: first input pixel, pixel count) that the kernel
    stages in order by bulk copies. Only tables whose input rows are whole
    16-byte units in any channel count (``in_row_px % 4 == 0``) stage;
    every busy band of any other table gathers from device memory.
    ``band[b]`` = (mode | BAND_HAS_REMAINDER, first
    segment, end segment, window pixels). Row r's first ``taps`` taps are
    ``tap_off[r]``/``tap_w[r]`` (weight-0 padding), the rest
    ``rem_off``/``rem_w`` over ``[rem_ptr[r], rem_ptr[r+1])``, all in
    request order. Offsets are pixels relative to the staged window (slot
    of the row in the window * in_row_px + column) for a staged band,
    absolute input pixels for a global one."""
    band_px: int
    in_row_px: int
    stage_px: int       # pixels of the widest staged window, rounded up to 4
    n_busy: int         # bands that are not empty
    band: torch.Tensor      # [bands, 4] int32
    seg: torch.Tensor       # [segments, 2] int32
    tap_off: torch.Tensor   # [bands * band_px, taps] int32
    tap_w: torch.Tensor     # [bands * band_px, taps]
    rem_ptr: torch.Tensor   # [bands * band_px + 1] int32
    rem_off: torch.Tensor   # [remainder] int32
    rem_w: torch.Tensor     # [remainder]

    @property
    def n_bands(self) -> int:
        return self.band.shape[0]

    @property
    def taps(self) -> int:
        return self.tap_off.shape[1]


@dataclasses.dataclass(frozen=True)
class GatherTable:
    """One direction of the warp: output row r is
    ``sum_t w[t] * x[col[t]]`` over ``t in [row_ptr[r], row_ptr[r+1])``,
    taps in request order. ``ell_col``/``ell_w`` hold the same taps padded
    to the longest row (padding has weight 0) for the plain version,
    ``bands`` in the CUDA kernel's form."""
    row_ptr: torch.Tensor   # [rows + 1] int32
    col: torch.Tensor       # [nnz] int32
    w: torch.Tensor         # [nnz]
    ell_col: torch.Tensor   # [rows, k] int64
    ell_w: torch.Tensor     # [rows, k]
    bands: BandTable

    @property
    def rows(self) -> int:
        return self.row_ptr.numel() - 1

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.row_ptr, self.col, self.w))


def _band_px(r, in_row, n_in_rows, width, in_row_px, cap):
    """Table rows per band for taps of table rows ``r`` reading input rows
    ``in_row``: the most whole image rows (``width`` table rows each, at
    most ``cap`` in all) whose widest window fits STAGE_BUDGET_PX;
    the most that fit ``cap`` if no height does (every band over budget
    then gathers from device memory); ``cap`` itself for rows wider than
    it."""
    cands = [h * width for h in range(cap // width, 0, -1)] or [cap]
    for px in cands:
        keys = np.unique(r // px * n_in_rows + in_row)
        if keys.size == 0 or \
                np.bincount(keys // n_in_rows).max() * in_row_px \
                <= STAGE_BUDGET_PX:
            return px
    return cands[0]


def _band_table(r, c, w, row_ptr, n_rows, width, n_in_px, in_row_px, cap,
                taps, dtype, device) -> BandTable:
    """BandTable of the CSR taps (r, c, w), sorted by row in request order.
    ``width``: table rows per image row; the input has ``n_in_px`` pixels in
    rows of ``in_row_px``."""
    n_in_rows = n_in_px // in_row_px
    in_row = c // in_row_px
    px = _band_px(r, in_row, n_in_rows, width, in_row_px, cap)
    nb = max(-(-n_rows // px), 1)
    band = r // px
    uniq, inv = np.unique(band * n_in_rows + in_row, return_inverse=True)
    u_band, u_row = uniq // n_in_rows, uniq % n_in_rows
    slots = np.bincount(u_band, minlength=nb)
    first_slot = np.concatenate([[0], np.cumsum(slots)])
    win_px = slots * in_row_px
    nnz_band = np.bincount(band, minlength=nb)
    stageable = (win_px <= STAGE_BUDGET_PX) & (in_row_px % 4 == 0)
    mode = np.where(nnz_band == 0, BAND_EMPTY,
                    np.where(stageable, BAND_STAGED, BAND_GLOBAL))

    # segments: runs of consecutive window rows of the staged bands
    st = mode[u_band] == BAND_STAGED
    sb, sr = u_band[st], u_row[st]
    new = np.ones(sb.size, bool)
    new[1:] = (sb[1:] != sb[:-1]) | (sr[1:] != sr[:-1] + 1)
    starts = np.flatnonzero(new)
    seg = np.stack([sr[starts] * in_row_px,
                    np.diff(np.append(starts, sb.size)) * in_row_px], 1)
    seg_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(sb[starts], minlength=nb))])

    staged = mode[band] == BAND_STAGED
    slot = inv.reshape(-1) - first_slot[band]
    off = np.where(staged, slot * in_row_px + c % in_row_px, c)
    rows_pad = nb * px
    pos = np.arange(r.size) - row_ptr[r]
    ell = pos < taps
    tap_off = np.zeros((rows_pad, taps), np.int64)
    tap_w = np.zeros((rows_pad, taps), w.dtype)
    tap_off[r[ell], pos[ell]] = off[ell]
    tap_w[r[ell], pos[ell]] = w[ell]
    rem = ~ell
    rem_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(r[rem], minlength=rows_pad))])
    has_rem = np.bincount(band[rem], minlength=nb) > 0
    info = np.stack([mode | np.where(has_rem, BAND_HAS_REMAINDER, 0),
                     seg_ptr[:-1], seg_ptr[1:],
                     np.where(mode == BAND_STAGED, win_px, 0)], 1)
    staged_px = win_px[mode == BAND_STAGED]
    stage_px = -(-int(staged_px.max()) // 4) * 4 if staged_px.size else 0

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return BandTable(
        band_px=int(px), in_row_px=int(in_row_px), stage_px=stage_px,
        n_busy=int((mode != BAND_EMPTY).sum()),
        band=t(info, torch.int32), seg=t(seg, torch.int32),
        tap_off=t(tap_off, torch.int32), tap_w=t(tap_w, dtype),
        rem_ptr=t(rem_ptr, torch.int32), rem_off=t(off[rem], torch.int32),
        rem_w=t(w[rem], dtype))


def _gather_table(rows_idx, cols_idx, w, n_rows: int, width: int,
                  n_in_px: int, in_row_px: int, cap: int, taps: int,
                  dtype, device) -> GatherTable:
    order = np.argsort(rows_idx, kind="stable")
    r, c, ww = rows_idx[order], cols_idx[order], w[order]
    counts = np.bincount(r, minlength=n_rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    k = max(int(counts.max()) if counts.size else 0, 1)
    slot = np.arange(r.size) - row_ptr[r]
    ell_col = np.zeros((n_rows, k), np.int64)
    ell_w = np.zeros((n_rows, k), np.float64)
    ell_col[r, slot] = c
    ell_w[r, slot] = ww

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    bands = _band_table(r, c, ww, row_ptr, n_rows, width, n_in_px, in_row_px,
                        cap, taps, dtype, device)
    return GatherTable(t(row_ptr, torch.int32), t(c, torch.int32),
                       t(ww, dtype), t(ell_col, torch.int64), t(ell_w, dtype),
                       bands)


@dataclasses.dataclass(frozen=True)
class FixedWarp:
    """The baked warp: source and output sizes plus both tables."""
    src_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    fwd: GatherTable    # rows = output pixels, cols = source pixels
    bwd: GatherTable    # the transpose: rows = source pixels


def build_fixed_warp(grid, src_hw, dst_weight=None, dtype=torch.float32,
                     device="cpu") -> FixedWarp:
    """Tables for a constant grid.

    grid: [1, Ho, Wo, 2] normalised (x, y) coordinates (tensor or array).
    src_hw: (H, W) of the images to be warped.
    dst_weight: optional [Ho, Wo] (or [Ho, Wo, 1]) per-output multiplier
        folded into the weights, e.g. PCNet's binary direct-light mask;
        taps whose folded weight is 0 are dropped.
    dtype: weight type; the CUDA kernel takes float32, the plain version
        follows the images' type (float64 in the parity tests).
    """
    if isinstance(grid, torch.Tensor):
        grid = grid.detach().cpu().numpy()
    grid_np = np.asarray(grid)[0]
    ho, wo = int(grid_np.shape[0]), int(grid_np.shape[1])
    h, w = int(src_hw[0]), int(src_hw[1])
    out_flat, src_flat, wgt = _bilinear_requests(grid_np, (h, w))
    wgt = wgt.astype(torch.empty((), dtype=dtype).numpy().dtype)
    if dst_weight is not None:
        if isinstance(dst_weight, torch.Tensor):
            dst_weight = dst_weight.detach().cpu().numpy()
        dw = np.asarray(dst_weight, wgt.dtype).reshape(ho * wo)
        wgt = wgt * dw[out_flat]
        keep = wgt != 0.0
        out_flat, src_flat, wgt = out_flat[keep], src_flat[keep], wgt[keep]
    return FixedWarp(
        src_hw=(h, w), out_hw=(ho, wo),
        fwd=_gather_table(out_flat, src_flat, wgt, ho * wo, wo, h * w, w,
                          FWD_BAND_CAPACITY, FWD_TAPS, dtype, device),
        bwd=_gather_table(src_flat, out_flat, wgt, h * w, w, ho * wo, wo,
                          BWD_BAND_CAPACITY, BWD_TAPS, dtype, device))


# ---------------------------------------------------------------- plain

def warp_forward_plain(warp: FixedWarp, src: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, C, Ho, Wo], by index gather and weighted sum."""
    n, h, w, c = src.shape
    t = warp.fwd
    vals = src.reshape(n, h * w, c)[:, t.ell_col, :]        # [N, Q, K, C]
    out = (vals * t.ell_w.to(src.dtype)[None, :, :, None]).sum(2)
    return out.permute(0, 2, 1).reshape(n, c, *warp.out_hw).contiguous()


def warp_backward_plain(warp: FixedWarp, dout: torch.Tensor) -> torch.Tensor:
    """[N, C, Ho, Wo] cotangent -> [N, H, W, C] gradient, the same gather
    on the transposed table."""
    n, c = dout.shape[:2]
    t = warp.bwd
    vals = dout.reshape(n, c, -1)[:, :, t.ell_col]          # [N, C, P, K]
    g = (vals * t.ell_w.to(dout.dtype)[None, None]).sum(3)
    return g.permute(0, 2, 1).reshape(n, *warp.src_hw, c).contiguous()


# --------------------------------------------------------------- kernel

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from spaa_tpu_torch.ops._build import load_library
        _LIB = bind_library(load_library("fixed_warp"))
    return _LIB


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``csrc/fixed_warp.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.fixed_warp_fwd, lib.fixed_warp_bwd):
        fn.argtypes = [p] * 9 + [i] * 6 + [ll, ll] + [i] * 2 + [p]
        fn.restype = ctypes.c_int
    lib.fixed_warp_error_string.argtypes = [ctypes.c_int]
    lib.fixed_warp_error_string.restype = ctypes.c_char_p
    for fn in (lib.fixed_warp_max_channels, lib.fixed_warp_band_capacity,
               lib.fixed_warp_taps):
        fn.restype = ctypes.c_int
    lib.fixed_warp_max_channels.argtypes = []
    lib.fixed_warp_band_capacity.argtypes = [i]
    lib.fixed_warp_taps.argtypes = [i]
    lib.fixed_warp_smem_bytes.argtypes = [i, i, i, i]
    lib.fixed_warp_smem_bytes.restype = ll
    lib.fixed_warp_kernel_attrs.argtypes = [i, p, p, p]
    lib.fixed_warp_kernel_attrs.restype = ctypes.c_int
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fixed warp {what} failed: CUDA error {rc} "
                           f"({lib.fixed_warp_error_string(rc).decode()})")


def kernel_attrs(backward: bool) -> dict:
    """Registers and local (spill) bytes per thread and static shared bytes
    of the forward or backward kernel, as the CUDA runtime reports them."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(3)]
    _check(lib, lib.fixed_warp_kernel_attrs(
        int(backward), *(ctypes.byref(v) for v in vals)), "attribute query")
    return dict(zip(("registers", "local_bytes", "static_smem"),
                    (v.value for v in vals)))


def smem_bytes(table: GatherTable, c: int, backward: bool) -> int:
    """Dynamic shared memory of one block of the kernel for this table."""
    b = table.bands
    return int(_lib().fixed_warp_smem_bytes(int(backward), b.band_px,
                                            b.stage_px, c))


def _launch(name: str, table: GatherTable, x: torch.Tensor,
            out: torch.Tensor, n: int, c: int, planar_in: bool, plane: int):
    """Check the operands and launch the band gather on the current stream:
    the forward kernel for interleaved (NHWC) input, the backward for
    planar (NCHW) input."""
    lib = _lib()
    b = table.bands
    if c > lib.fixed_warp_max_channels():
        raise ValueError(f"fixed warp kernel takes at most "
                         f"{lib.fixed_warp_max_channels()} channels, got {c}")
    if b.band_px > lib.fixed_warp_band_capacity(int(planar_in)) or \
            b.taps != lib.fixed_warp_taps(int(planar_in)):
        raise ValueError("fixed warp tables were built for another kernel "
                         "configuration (band pixels, taps)")
    for nm, t, dt in (("input", x, torch.float32),
                      ("band", b.band, torch.int32),
                      ("seg", b.seg, torch.int32),
                      ("tap_off", b.tap_off, torch.int32),
                      ("tap_w", b.tap_w, torch.float32),
                      ("rem_ptr", b.rem_ptr, torch.int32),
                      ("rem_off", b.rem_off, torch.int32),
                      ("rem_w", b.rem_w, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"fixed warp {nm} is on {t.device}, the input "
                             f"on {x.device}: build the tables on the "
                             "input's device")
        if t.dtype != dt:
            raise TypeError(f"fixed warp kernel needs {nm} as {dt}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fixed warp {nm} must be contiguous")
    if n == 0:
        return out
    if b.stage_px and x.data_ptr() % 16:
        # bulk copies read from 16-byte-aligned addresses; the tables make
        # every row offset a multiple of 16 bytes, so realign the base
        x = x.clone()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = lib.fixed_warp_bwd if planar_in else lib.fixed_warp_fwd
        rc = fn(x.data_ptr(), out.data_ptr(), b.band.data_ptr(),
                b.seg.data_ptr(), b.tap_off.data_ptr(), b.tap_w.data_ptr(),
                b.rem_ptr.data_ptr(), b.rem_off.data_ptr(),
                b.rem_w.data_ptr(), b.n_bands, b.n_busy, b.band_px,
                table.rows, n, c, x[0].numel(), out[0].numel(), plane,
                b.stage_px, stream)
    _check(lib, rc, "kernel launch")
    count_launch(name)
    return out


def warp_forward(warp: FixedWarp, src: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, C, Ho, Wo]: the kernel on CUDA, plain on CPU."""
    n, h, w, c = src.shape
    if (h, w) != warp.src_hw:
        raise ValueError(f"warp expects {warp.src_hw} source images, "
                         f"got {(h, w)}")
    if src.device.type == "cpu":
        return warp_forward_plain(warp, src)
    if src.device.type != "cuda":
        raise ValueError(f"fixed warp runs on cuda or cpu, not {src.device}")
    if not src.is_contiguous():
        raise ValueError("fixed warp input must be a contiguous NHWC tensor")
    ho, wo = warp.out_hw
    out = torch.empty((n, c, ho, wo), device=src.device, dtype=src.dtype)
    return _launch("fixed_warp_fwd", warp.fwd, src, out, n, c,
                   planar_in=False, plane=h * w)


def warp_backward(warp: FixedWarp, dout: torch.Tensor) -> torch.Tensor:
    """[N, C, Ho, Wo] -> [N, H, W, C]: the kernel on CUDA, plain on CPU."""
    n, c, ho, wo = dout.shape
    if (ho, wo) != warp.out_hw:
        raise ValueError(f"warp cotangent must be {warp.out_hw}, "
                         f"got {(ho, wo)}")
    if dout.device.type == "cpu":
        return warp_backward_plain(warp, dout)
    if dout.device.type != "cuda":
        raise ValueError(f"fixed warp runs on cuda or cpu, not {dout.device}")
    if not dout.is_contiguous():
        raise ValueError("fixed warp cotangent must be a contiguous NCHW "
                         "tensor")
    h, w = warp.src_hw
    out = torch.empty((n, h, w, c), device=dout.device, dtype=dout.dtype)
    return _launch("fixed_warp_bwd", warp.bwd, dout, out, n, c,
                   planar_in=True, plane=ho * wo)


class _FixedWarpFn(torch.autograd.Function):
    """Differentiable w.r.t. the image; saves only the tables."""

    @staticmethod
    def forward(ctx, src, warp):
        ctx.warp = warp
        return warp_forward(warp, src)

    @staticmethod
    def backward(ctx, dout):
        return warp_backward(ctx.warp, dout.contiguous()), None


def fixed_warp_apply(warp: FixedWarp, im: torch.Tensor) -> torch.Tensor:
    """Warp NHWC ``im`` [N, H, W, C] -> NHWC [N, Ho, Wo, C] (a view of an
    NCHW tensor). Differentiable w.r.t. ``im``."""
    return _FixedWarpFn.apply(im.contiguous(), warp).permute(0, 2, 3, 1)
