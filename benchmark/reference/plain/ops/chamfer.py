"""Chamfer distances, batched and differentiable, and the min squared
distance they are built on.

Counterpart of parsenet_tpu/ops/chamfer.py (reference src/utils.py:
273-358). Every distance goes through `kernels.MinSqdist`: K3 forward, K4
backward (the TPU path's `jax.vmap(min_sqdist_fused)`). Masked targets get
+1e30 as in the TPU kernel; the JAX package's own XLA fallback masks with
1e10 instead, which only shows where every target of a query is masked.
Masks are [B, N] weights, > 0 keeps a point; invalid points are left out of
both the min and the mean.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels import MinSqdist


def min_sqdist(q: torch.Tensor, x: torch.Tensor,
               x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-query min squared distance over the kept targets, differentiable
    in q and x. q: [B, N, 3], x: [B, M, 3] -> [B, N]; or q [N, 3], x [M, 3]
    -> [N]."""
    if q.dim() == 2:
        return min_sqdist(q[None], x[None],
                          None if x_mask is None else x_mask[None])[0]
    return MinSqdist.apply(q.contiguous(), x.contiguous(), x_mask)


def _ones(t: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones(t.shape[:2], dtype=t.dtype, device=t.device) \
        if mask is None else mask


def _root(d: torch.Tensor, sqrt: bool) -> torch.Tensor:
    return torch.sqrt(torch.clamp(d, min=1e-10)) if sqrt else d


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     x_mask: Optional[torch.Tensor] = None,
                     y_mask: Optional[torch.Tensor] = None,
                     sqrt: bool = False) -> torch.Tensor:
    """Two-sided chamfer, mean over the batch: 0.5 (mean_x min_y + mean_y
    min_x). x: [B, N, 3], y: [B, M, 3] -> scalar."""
    x_mask, y_mask = _ones(x, x_mask), _ones(y, y_mask)
    d_xy = _root(min_sqdist(x, y, y_mask), sqrt)
    d_yx = _root(min_sqdist(y, x, x_mask), sqrt)
    m_xy = torch.sum(d_xy * x_mask, -1) / (torch.sum(x_mask, -1) + 1e-8)
    m_yx = torch.sum(d_yx * y_mask, -1) / (torch.sum(y_mask, -1) + 1e-8)
    return torch.mean(0.5 * (m_xy + m_yx))


def chamfer_distance_one_side(x: torch.Tensor, y: torch.Tensor,
                              side: int = 1,
                              x_mask: Optional[torch.Tensor] = None,
                              y_mask: Optional[torch.Tensor] = None,
                              sqrt: bool = False) -> torch.Tensor:
    """One-sided chamfer, x = prediction, y = ground truth. side=1: each y
    point's distance to its nearest x ("the prediction covers the gt", the
    spline training loss); side=0: each x point's to its nearest y."""
    x_mask, y_mask = _ones(x, x_mask), _ones(y, y_mask)
    if side == 1:
        d, w = min_sqdist(y, x, x_mask), y_mask
    else:
        d, w = min_sqdist(x, y, y_mask), x_mask
    d = _root(d, sqrt)
    return torch.mean(torch.sum(d * w, -1) / (torch.sum(w, -1) + 1e-8))


def chamfer_distance_single_shape(x: torch.Tensor, y: torch.Tensor,
                                  x_mask: Optional[torch.Tensor] = None,
                                  y_mask: Optional[torch.Tensor] = None,
                                  sqrt: bool = False, one_side: bool = False,
                                  reduce: bool = True):
    """Unbatched chamfer between two clouds [N, 3], [M, 3]. one_side keeps
    only x -> y; reduce=False returns the per-point distances."""
    d_xy = _root(min_sqdist(x, y, y_mask), sqrt)
    wx = torch.ones_like(d_xy) if x_mask is None else x_mask
    if one_side:
        if not reduce:
            return d_xy
        return torch.sum(d_xy * wx) / (torch.sum(wx) + 1e-8)
    d_yx = _root(min_sqdist(y, x, x_mask), sqrt)
    wy = torch.ones_like(d_yx) if y_mask is None else y_mask
    if not reduce:
        return d_xy, d_yx
    return 0.5 * (torch.sum(d_xy * wx) / (torch.sum(wx) + 1e-8)
                  + torch.sum(d_yx * wy) / (torch.sum(wy) + 1e-8))
