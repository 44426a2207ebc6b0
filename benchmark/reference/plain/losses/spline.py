"""SplineNet's training losses for closed control grids.

The benchmark's frozen copy of the port's losses/spline.py (reference
src/loss.py), the parts a closed SplineNet trains with: the
permutation-min control-point loss over the 80 symmetries of a closed grid
(4 flips x `grid` cyclic rolls along u) as one stacked min, and the
one-sided chamfer from the input points to the surface that the B-spline
basis samples from the predicted grid.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.bspline import sample_surface
from ..ops.chamfer import chamfer_distance_one_side


def _flips(cp: torch.Tensor, a: int) -> list:
    """cp and its flips along axes a, a + 1 and both."""
    return [cp, torch.flip(cp, (a,)), torch.flip(cp, (a + 1,)),
            torch.flip(cp, (a, a + 1))]


def _permutation_min(output: torch.Tensor, perms: torch.Tensor, grid: int):
    b = output.shape[0]
    out = output.reshape(b, 1, grid, grid, 3)
    diff = torch.sum((out - perms) ** 2, dim=(2, 3, 4))     # [B, P]
    best_d, idx = torch.min(diff, dim=1)
    loss = torch.mean(best_d) / (grid * grid * 3)
    best = perms[torch.arange(b, device=perms.device), idx]
    return loss, best


def control_points_permute_closed_reg_loss(output: torch.Tensor,
                                           cp: torch.Tensor, grid: int
                                           ) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Min over the 4 flips of each of the `grid` cyclic rolls along u
    (index roll * 4 + flip). output [B, G*G, 3], cp [B, G, G, 3] -> (loss,
    best-permuted gt [B, G, G, 3])."""
    rolls = torch.stack([torch.roll(cp, i, dims=1) for i in range(grid)], 1)
    perms = torch.stack(_flips(rolls, 2), dim=2)        # [B, grid, 4, ...]
    perms = perms.reshape(cp.shape[0], grid * 4, grid, grid, 3)
    return _permutation_min(output, perms, grid)


def spline_reconstruction_loss_one_sided(nu: torch.Tensor, nv: torch.Tensor,
                                         output: torch.Tensor,
                                         points: torch.Tensor,
                                         side: int = 1):
    """One-sided chamfer: the predicted surface covers the points.
    output [B, G*G, 3], points [B, N, 3] -> (loss, surface)."""
    g = int(round(output.shape[1] ** 0.5))
    recon = sample_surface(nu, nv, output.reshape(output.shape[0], g, g, 3))
    return chamfer_distance_one_side(recon, points, side=side), recon
