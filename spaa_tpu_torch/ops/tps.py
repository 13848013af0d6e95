"""Thin-plate-spline sampling grids (counterpart of ``spaa_tpu/ops/tps.py``,
reference ``pytorch_tps.py:29-217``). Grids are [N, H, W, 2] with (x, y)
channels, as :func:`spaa_tpu_torch.ops.image.grid_sample` takes them."""

from __future__ import annotations

import torch


def uniform_grid(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """[H, W, 2] control points uniformly spanning [0, 1]^2, (x, y)."""
    h, w = int(shape[0]), int(shape[1])
    xs = torch.linspace(0.0, 1.0, w, dtype=dtype, device=device)
    ys = torch.linspace(0.0, 1.0, h, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _tps_radial(grid_xy: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """U = D^2 log(D + 1e-6): grid [N, H, W, 2], ctrl [N, T, 2] -> [N, H, W, T]."""
    diff = grid_xy[:, :, :, None, :] - ctrl[:, None, None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return (d * d) * torch.log(d + 1e-6)


def _expand_theta(theta: torch.Tensor, num_ctrl: int) -> torch.Tensor:
    """Reduced theta [N, T+2, C] -> full [N, T+3, C] (ref ``:67-69``)."""
    if theta.shape[1] == num_ctrl + 2:
        w = theta[:, :-3, :]
        w = torch.cat([-torch.sum(w, dim=1, keepdim=True), w], dim=1)
        return torch.cat([w, theta[:, -3:, :]], dim=1)
    return theta


def tps(theta: torch.Tensor, ctrl: torch.Tensor,
        grid: torch.Tensor) -> torch.Tensor:
    """TPS surface: theta [N, T+3 | T+2, C], ctrl [T, 2] or [N, T, 2],
    grid [N, H, W, 3] of (1, x, y) -> [N, H, W, C]."""
    n = grid.shape[0]
    if ctrl.ndim == 2:
        ctrl = ctrl.expand(n, *ctrl.shape)
    theta = _expand_theta(theta, ctrl.shape[1])
    u = _tps_radial(grid[..., 1:], ctrl)
    w, a = theta[:, :-3, :], theta[:, -3:, :]
    b = torch.einsum("nhwt,ntc->nhwc", u, w)
    return torch.einsum("nhwj,njc->nhwc", grid, a) + b


def _homogeneous_grid(n: int, h: int, w: int, dtype, device) -> torch.Tensor:
    g = uniform_grid((h, w), dtype, device)
    g = torch.cat([torch.ones_like(g[..., :1]), g], dim=-1)
    return g.expand(n, h, w, 3)


def tps_grid(theta: torch.Tensor, ctrl: torch.Tensor, size) -> torch.Tensor:
    """Sampling grid in [-1, 1]; size (N, C, H, W) or (N, H, W)."""
    if len(size) == 4:
        n, _, h, w = size
    else:
        n, h, w = size
    g = _homogeneous_grid(int(n), int(h), int(w), theta.dtype, theta.device)
    return (g[..., 1:] + tps(theta, ctrl, g)) * 2.0 - 1.0


def tps_d(theta: torch.Tensor, ctrl: torch.Tensor,
          grid: torch.Tensor) -> torch.Tensor:
    """1-D output TPS (depth approximation): theta [N, T+3 | T+2, 1] ->
    z [N, H, W, 1] (ref ``pytorch_tps.py:109-157``): :func:`tps` with one
    output channel."""
    return tps(theta, ctrl, grid)


def tps_depth(theta: torch.Tensor, ctrl: torch.Tensor,
              size) -> torch.Tensor:
    """TPS depth map [N, H, W, 1] on the uniform homogeneous grid; size
    (N, C, H, W) or (N, H, W) (ref ``pytorch_tps.py:160-186``)."""
    if len(size) == 4:
        n, _, h, w = size
    else:
        n, h, w = size
    g = _homogeneous_grid(int(n), int(h), int(w), theta.dtype, theta.device)
    return tps_d(theta, ctrl, g)


def tps_sparse(theta: torch.Tensor, ctrl: torch.Tensor,
               xy: torch.Tensor) -> torch.Tensor:
    """The TPS warp of sparse (x, y) points [N, M, 2] (or [M, 2]): each
    point plus its displacement (ref ``pytorch_tps.py:188-198``)."""
    if xy.ndim == 2:
        xy = xy.expand(theta.shape[0], *xy.shape)
    n, m = xy.shape[:2]
    grid = torch.cat([torch.ones_like(xy[..., :1]), xy], dim=-1)
    z = tps(theta, ctrl, grid.reshape(n, m, 1, 3))
    return xy + z.reshape(n, m, 2)
