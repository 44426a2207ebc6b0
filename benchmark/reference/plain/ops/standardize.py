"""Per-segment canonicalisation before SplineNet.

Counterpart of parsenet_tpu/ops/standardize.py (reference
src/fitting_utils.py:493-583): pick the confident subset of a weighted
segment, mean-centre it, rotate the minor principal axis onto x and scale
by the weighted bounding-box extent. Batched over a leading slot axis.
Gradients flow through the weighted mean into the points and weights; the
rotation and the scale are detached, as in the JAX package (the
reference's numpy round-trip).

The minor axis is column 0 of `linalg.safe_eigh`, exactly as the JAX
package's Jacobi eigh gives it, with no sign rule:
`linalg.smallest_eigvec` makes the largest component positive, which the
JAX standardize_points does not, and the SplineNet is not invariant to
that flip.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.guards import EPS
from .linalg import safe_eigh


class Standardization(NamedTuple):
    points: torch.Tensor  # [..., N, 3] canonicalised
    mean: torch.Tensor    # [..., 3]
    R: torch.Tensor       # [..., 3, 3] applied rotation (x' = R x)
    std: torch.Tensor     # [..., 3] bounding-box scales


def rotation_matrix_a_to_b(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Rotations with R @ A = B for unit 3-vectors A, B [..., 3] -> [..., 3, 3]
    (reference: src/fitting_utils.py:556-583); the 1e-8 ridge keeps the
    degenerate A ~ B case finite, as in the JAX package."""
    cos = torch.sum(A * B, dim=-1)
    w = torch.linalg.cross(B, A)
    sin = torch.linalg.norm(w, dim=-1)
    v = B - cos[..., None] * A
    v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + EPS)
    w = w / (sin[..., None] + EPS)
    F = torch.stack([A, v, w], dim=-1)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    G = eye.expand(F.shape).clone()
    G[..., 0, 0] = cos
    G[..., 0, 1] = -sin
    G[..., 1, 0] = sin
    G[..., 1, 1] = cos
    Finv = torch.linalg.solve(F + 1e-8 * eye, eye.expand(F.shape))
    return F @ G @ Finv


def standardize_points(points: torch.Tensor, weights: torch.Tensor,
                       conf_threshold: float = 0.8,
                       min_confident: int = 400) -> Standardization:
    """points [..., N, 3], weights [..., N] soft membership.

    Confident subset: weights > 0.8, or, where fewer than `min_confident`
    qualify, the top quarter (N >= 7,500) or half by weight
    (reference: src/fitting_utils.py:512-521)."""
    n = points.shape[-2]
    conf = (weights > conf_threshold).to(torch.float32)
    k = max(n // 4 if n >= 7500 else n // 2, 1)
    kth = torch.sort(weights, dim=-1).values[..., n - k]
    topk_mask = (weights >= kth[..., None]).to(torch.float32)
    use_topk = torch.sum(conf, dim=-1, keepdim=True) < min_confident
    mask = torch.where(use_topk, topk_mask, conf)

    w = (weights * mask)[..., None]
    wsum = torch.sum(w, dim=(-2, -1))[..., None] + EPS
    mean = torch.sum(points * w, dim=-2) / wsum
    centered = points - mean[..., None, :]
    sel = (centered * mask[..., None]).detach()
    cov = sel.transpose(-1, -2) @ sel
    smallest = safe_eigh(cov)[1][..., :, 0]
    x_axis = torch.zeros_like(smallest)
    x_axis[..., 0] = 1.0
    R = rotation_matrix_a_to_b(smallest, x_axis)
    rotated = centered @ R.transpose(-1, -2)

    wp = (rotated * w).detach()
    keep = mask[..., None] > 0
    hi = torch.amax(torch.where(keep, wp, -1e9), dim=-2)
    lo = torch.amin(torch.where(keep, wp, 1e9), dim=-2)
    std = torch.abs(hi - lo)
    return Standardization(rotated / (std[..., None, :] + EPS), mean, R, std)


def unstandardize_points(points: torch.Tensor,
                         st: Standardization) -> torch.Tensor:
    """Invert standardize_points for surface samples [..., M, 3]
    (reference: src/primitive_forward.py:58-64)."""
    p = points * (st.std[..., None, :] + EPS)
    return p @ st.R + st.mean[..., None, :]
