"""SplineNet training losses.

Counterpart of parsenet_tpu/losses/spline.py (reference src/loss.py): the
permutation-min control-point loss (8 flips and transposes of an open grid;
4 flips x `grid` cyclic rolls of a closed one) as one stacked min, the
reconstruction chamfer between the sampled surface and the input points,
and the 5-point Laplacian loss as a fixed depthwise stencil.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.bspline import sample_surface
from ..ops.chamfer import chamfer_distance, chamfer_distance_one_side


def _flips(cp: torch.Tensor, a: int) -> list:
    """cp and its flips along axes a, a + 1 and both."""
    return [cp, torch.flip(cp, (a,)), torch.flip(cp, (a + 1,)),
            torch.flip(cp, (a, a + 1))]


def all_permutations(cp: torch.Tensor) -> torch.Tensor:
    """The 8 symmetries of open grids [B, G, G, 3] -> [B, 8, G, G, 3]."""
    f = _flips(cp, 1)
    return torch.stack(f + [t.transpose(1, 2) for t in f], dim=1)


def all_permutations_half(cp: torch.Tensor) -> torch.Tensor:
    """The 4 flips of closed grids [B, G, G, 3] -> [B, 4, G, G, 3]."""
    return torch.stack(_flips(cp, 1), dim=1)


def _permutation_min(output: torch.Tensor, perms: torch.Tensor, grid: int):
    b = output.shape[0]
    out = output.reshape(b, 1, grid, grid, 3)
    diff = torch.sum((out - perms) ** 2, dim=(2, 3, 4))     # [B, P]
    best_d, idx = torch.min(diff, dim=1)
    loss = torch.mean(best_d) / (grid * grid * 3)
    best = perms[torch.arange(b, device=perms.device), idx]
    return loss, best


def control_points_permute_reg_loss(output: torch.Tensor, cp: torch.Tensor,
                                    grid: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-over-8-permutations MSE. output [B, G*G, 3], cp [B, G, G, 3] ->
    (loss, best-permuted gt [B, G, G, 3])."""
    return _permutation_min(output, all_permutations(cp), grid)


def control_points_permute_closed_reg_loss(output: torch.Tensor,
                                           cp: torch.Tensor, grid: int
                                           ) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Min over the 4 flips of each of the `grid` cyclic rolls along u
    (index roll * 4 + flip, as the JAX package stacks them)."""
    rolls = torch.stack([torch.roll(cp, i, dims=1) for i in range(grid)], 1)
    perms = torch.stack(_flips(rolls, 2), dim=2)        # [B, grid, 4, ...]
    perms = perms.reshape(cp.shape[0], grid * 4, grid, grid, 3)
    return _permutation_min(output, perms, grid)


def _surface(nu, nv, output):
    g = int(round(output.shape[1] ** 0.5))
    return sample_surface(nu, nv, output.reshape(output.shape[0], g, g, 3))


def spline_reconstruction_loss(nu: torch.Tensor, nv: torch.Tensor,
                               output: torch.Tensor, points: torch.Tensor,
                               sqrt: bool = False):
    """Two-sided chamfer between the sampled surface and the points.
    output [B, G*G, 3], points [B, N, 3] -> (loss, surface)."""
    recon = _surface(nu, nv, output)
    return chamfer_distance(recon, points, sqrt=sqrt), recon


def spline_reconstruction_loss_one_sided(nu: torch.Tensor, nv: torch.Tensor,
                                         output: torch.Tensor,
                                         points: torch.Tensor, side: int = 1):
    """One-sided chamfer: the predicted surface covers the points."""
    recon = _surface(nu, nv, output)
    return chamfer_distance_one_side(recon, points, side=side), recon


_LAP_STENCIL = ((0.0, 0.25, 0.0), (0.25, -1.0, 0.25), (0.0, 0.25, 0.0))


def laplacian_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L2 between the 5-point Laplacians of the predicted and gt control
    grids, both [B, G, G, 3] (zero padding, per xyz channel)."""
    k = torch.tensor(_LAP_STENCIL, dtype=output.dtype, device=output.device)
    k = k.expand(3, 1, 3, 3)

    def lap(x):
        return F.conv2d(x.permute(0, 3, 1, 2), k, padding=1, groups=3)

    d = (lap(output) - lap(gt)) ** 2
    return torch.mean(torch.sum(d, dim=1))
