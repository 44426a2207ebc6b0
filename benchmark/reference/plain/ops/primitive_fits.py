"""Weighted closed-form primitive fits (plane / sphere / cylinder / cone).

Counterpart of parsenet_tpu/ops/primitive_fits.py (reference
src/primitive_forward.py:695-843). Where the JAX package fits one segment
and vmaps, every fit here takes points [..., N, 3] (shared [N, 3] or per
segment) and weights [..., N] with the segment axis written out, so all K
segments of a shape fit in one pass. Degenerate (empty) segments give
finite values that callers mask.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.guards import EPS, guard_sqrt
from .linalg import ridge_lstsq, smallest_eigvec


class PlaneParams(NamedTuple):
    normal: torch.Tensor  # [..., 3] unit
    offset: torch.Tensor  # [...] plane is {p : <normal, p> = offset}


class SphereParams(NamedTuple):
    center: torch.Tensor  # [..., 3]
    radius: torch.Tensor  # [...]


class CylinderParams(NamedTuple):
    axis: torch.Tensor    # [..., 3] unit
    center: torch.Tensor  # [..., 3] point on the axis
    radius: torch.Tensor  # [...]


class ConeParams(NamedTuple):
    apex: torch.Tensor    # [..., 3]
    axis: torch.Tensor    # [..., 3] unit, pointing into the cone
    theta: torch.Tensor   # [...] half-angle


class AllPrimParams(NamedTuple):
    plane: PlaneParams
    sphere: SphereParams
    cylinder: CylinderParams
    cone: ConeParams


def _dot3(points: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """<p_i, v> for points [..., N, 3], v [..., 3] -> [..., N]."""
    return torch.sum(points * v[..., None, :], dim=-1)


def fit_plane(points: torch.Tensor, weights: torch.Tensor) -> PlaneParams:
    """normal = smallest eigenvector of (w X)^T (w X), X mean-centred;
    offset = sum w <normal, p> / sum w."""
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2) + EPS                     # [..., 1]
    centroid = torch.sum(w * points, dim=-2) / wsum       # [..., 3]
    X = (points - centroid[..., None, :]) * w
    a = smallest_eigvec(X.transpose(-1, -2) @ X)
    d = torch.sum(weights * _dot3(points, a), dim=-1) / wsum[..., 0]
    return PlaneParams(a, d)


def fit_sphere(points: torch.Tensor, weights: torch.Tensor,
               lam: float = 1e-6) -> SphereParams:
    """Centre by weighted linear least squares (the reference's doubly
    weighted system), then the weighted RMS radius."""
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2) + EPS                     # [..., 1]
    A = 2.0 * (-points + (torch.sum(points * w, dim=-2) / wsum)[..., None, :])
    dot = w * torch.sum(points * points, dim=-1, keepdim=True)
    Y = dot - (torch.sum(dot, dim=-2) / wsum)[..., None, :]
    center = -ridge_lstsq(w * A, w * Y, lam)[..., :, 0]
    r2 = torch.sum(weights * torch.sum((points - center[..., None, :]) ** 2,
                                       dim=-1), dim=-1) / wsum[..., 0]
    return SphereParams(center, guard_sqrt(torch.clamp(r2, min=1e-3)))


def fit_cylinder(points: torch.Tensor, normals: torch.Tensor,
                 weights: torch.Tensor) -> CylinderParams:
    """axis = smallest eigenvector of (w N)^T (w N); centre and radius from
    a sphere fit of the points projected onto the plane normal to it."""
    WN = normals * weights[..., None]
    a = smallest_eigvec(WN.transpose(-1, -2) @ WN)
    a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + EPS)
    prj = points - _dot3(points, a)[..., None] * a[..., None, :]
    center, _ = fit_sphere(prj, weights)
    center = center - torch.sum(center * a, dim=-1, keepdim=True) * a
    wsum = torch.sum(weights, dim=-1) + EPS
    r2 = torch.sum(weights * torch.sum((prj - center[..., None, :]) ** 2,
                                       dim=-1), dim=-1) / wsum
    return CylinderParams(a, center, guard_sqrt(torch.clamp(r2, min=1e-6)))


def fit_cone(points: torch.Tensor, normals: torch.Tensor,
             weights: torch.Tensor) -> ConeParams:
    """apex from <n_i, c> = <n_i, p_i> in weighted LS; axis = plane-fit
    normal of the normals, flipped into the cone; half-angle = weighted mean
    angle between (p - c) and the axis."""
    w = weights[..., None]
    A = w * normals
    Y = w * torch.sum(normals * points, dim=-1, keepdim=True)
    apex = ridge_lstsq(A, Y, 1e-4)[..., :, 0]
    a, _ = fit_plane(normals, weights)
    flip = torch.where(torch.sum(weights * _dot3(normals, a), dim=-1) > 0,
                       -1.0, 1.0)
    a = a * flip[..., None]
    diff = points - apex[..., None, :]
    diff = diff / (torch.linalg.norm(diff, dim=-1, keepdim=True) + EPS)
    cosang = torch.clamp(torch.abs(_dot3(diff, a)), max=0.999)
    theta = (torch.sum(weights * torch.arccos(cosang), dim=-1)
             / (torch.sum(weights, dim=-1) + EPS))
    theta = torch.clamp(theta, 1e-3, math.pi / 2 - 1e-3)
    return ConeParams(apex, a, theta)


def fit_all_primitives(points: torch.Tensor, normals: torch.Tensor,
                       weights: torch.Tensor) -> AllPrimParams:
    """All four fits of one weighted segment: points/normals [N, 3],
    weights [N] (or segments stacked on leading axes: [..., N, 3] and
    [..., N]). Fitting every type lets the per-segment type dispatch of
    the reference (src/primitive_forward.py:925-1047) be a select."""
    return AllPrimParams(
        plane=fit_plane(points, weights),
        sphere=fit_sphere(points, weights),
        cylinder=fit_cylinder(points, normals, weights),
        cone=fit_cone(points, normals, weights),
    )


# the JAX package's vmaps over a leading segment axis (points [K, N, 3],
# weights [K, N]): every fit here takes leading axes as they come
fit_plane_batched = fit_plane
fit_sphere_batched = fit_sphere
fit_cylinder_batched = fit_cylinder
fit_cone_batched = fit_cone
fit_all_primitives_batched = fit_all_primitives


def fit_all_primitives_shared_points(points: torch.Tensor,
                                     normals: torch.Tensor,
                                     weights: torch.Tensor) -> AllPrimParams:
    """All four fits for K segments of one cloud: points/normals [N, 3],
    weights [K, N] -> parameters stacked over K."""
    return fit_all_primitives(points, normals, weights)
