"""WarpingNet: learnable affine + TPS + CNN-refined sampling grid.

Counterpart of ``spaa_tpu/models/warping_net.py`` (reference
``models.py:98-185``). In PCNet's attack only the baked grid is used
(:meth:`WarpingNet.simplify`); the warp itself is the fixed-grid kernel of
``spaa_tpu_torch.ops.warp``. In training, PCNet's forward builds the grid
with :meth:`WarpingNet.fine_grid` and samples through ``ops.image``'s
``grid_sample``, both differentiable in the grid's parameters; CompenNet++
calls :meth:`WarpingNet.forward`, which samples the same way, as
``spaa_tpu``'s does. Grids are [N, H, W, 2] with (x, y) in [-1, 1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spaa_tpu_torch.ops.image import affine_grid, grid_sample
from spaa_tpu_torch.ops.tps import tps_grid, uniform_grid


class GridRefineNet(nn.Module):
    """CNN refinement of the 2-channel grid image (ref ``models.py:130-140``)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 32, 3, 2, 1)
        self.conv2 = nn.Conv2d(32, 64, 3, 2, 1)
        self.tconv1 = nn.ConvTranspose2d(64, 32, 2, 2, 0)
        self.tconv2 = nn.ConvTranspose2d(32, 2, 2, 2, 0)

    def forward(self, g: torch.Tensor) -> torch.Tensor:   # NCHW
        x = F.relu(self.conv1(g))
        x = F.relu(self.conv2(x))
        x = F.relu(self.tconv1(x))
        return F.leaky_relu(self.tconv2(x), negative_slope=0.1)


class WarpingNet(nn.Module):
    """Geometric projector -> camera warp; ``out_size`` is (H, W)."""

    def __init__(self, out_size: Tuple[int, int] = (256, 256),
                 grid_shape: Tuple[int, int] = (6, 6),
                 with_refine: bool = True):
        super().__init__()
        self.out_size = tuple(out_size)
        self.grid_shape = tuple(grid_shape)
        self.with_refine = with_refine
        nparam = grid_shape[0] * grid_shape[1] + 2   # reduced-form theta
        self.affine_mat = nn.Parameter(
            torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]]))
        self.theta = nn.Parameter(torch.full((1, nparam, 2), 1e-3))
        if with_refine:
            self.grid_refine_net = GridRefineNet()

    def fine_grid(self) -> torch.Tensor:
        """The final [1, H, W, 2] sampling grid (ref ``models.py:149-161``)."""
        h, w = self.out_size
        coarse_affine = affine_grid(self.affine_mat, (h, w))
        ctrl = uniform_grid(self.grid_shape, self.theta.dtype,
                            self.theta.device).reshape(-1, 2)
        coarse_tps = tps_grid(self.theta, ctrl, (1, h, w))
        grid = grid_sample(coarse_affine, coarse_tps)
        if self.with_refine:
            refine = self.grid_refine_net(grid.permute(0, 3, 1, 2))
            grid = grid + refine.permute(0, 2, 3, 1)
        return torch.clamp(grid, -1.0, 1.0)

    def forward(self, x: torch.Tensor,
                fine_grid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Warp NHWC ``x`` [N, H, W, C] to ``out_size``; a precomputed
        ``fine_grid`` (:meth:`simplify`) skips the grid math (ref
        ``models.py:179-181``). The grid stays [1, H, W, 2] for the batch."""
        if fine_grid is None:
            fine_grid = self.fine_grid()
        return grid_sample(x, fine_grid)

    def simplify(self) -> torch.Tensor:
        """The baked sampling grid."""
        return self.fine_grid()


def affine_from_corners(mask_corners, inverse: bool = False) -> torch.Tensor:
    """Initial [1, 2, 3] affine from the direct-light mask's bounding-box
    corners (in [-1, 1] grid coordinates), as ``spaa_tpu``'s
    ``affine_from_corners`` (ref ``train_network.py:543-546``): the map
    taking the first three corners to (-1,-1), (1,-1), (1,1), since
    ``grid_sample`` warps inversely. ``inverse=True`` gives the opposite
    map, the init of CompenNet++'s warp (PARITY.md "Known deviations")."""
    dst = np.asarray(mask_corners[0:3], np.float64)
    src = np.array([[-1, -1], [1, -1], [1, 1]], np.float64)
    if inverse:
        dst, src = src, dst
    m = np.concatenate([dst, np.ones((3, 1))], axis=1)
    aff = np.linalg.solve(m, src).T
    return torch.from_numpy(aff[None].astype(np.float32))
