"""Closed-form point-to-primitive squared distances.

Counterpart of parsenet_tpu/ops/primitive_dist.py (reference
src/primitives.py:47-206). Each routine maps points [N, 3] and parameters
stacked over K segments to squared distances [K, N]; `residual_select`
picks each segment's own type.
"""
from __future__ import annotations

import math

import torch

from ..core.guards import guard_sqrt
from .primitive_fits import AllPrimParams

LABEL_PLANE = 1
LABEL_CONE = 3
LABEL_CYLINDER = 4
LABEL_SPHERE = 5

# geometric-type codes used inside the fitting pipeline
GEOM_PLANE, GEOM_SPHERE, GEOM_CYLINDER, GEOM_CONE = 0, 1, 2, 3


def sqdist_plane(points, normal, offset):
    """points [N, 3], normal [K, 3], offset [K] -> [K, N]."""
    return (normal @ points.T - offset[:, None]) ** 2


def sqdist_sphere(points, center, radius):
    """center [K, 3], radius [K] -> [K, N]."""
    d = torch.linalg.norm(points[None] - center[:, None], dim=-1) - radius[:, None]
    return d * d


def sqdist_cylinder(points, axis, center, radius):
    """axis, center [K, 3], radius [K] -> [K, N]."""
    v = points[None] - center[:, None]
    along = torch.sum(v * axis[:, None], dim=-1)
    perp2 = torch.clamp(torch.sum(v * v, dim=-1) - along * along, min=1e-5)
    d = torch.sqrt(perp2) - radius[:, None]
    return d * d


def sqdist_cone(points, apex, axis, theta):
    """apex, axis [K, 3], theta [K] -> [K, N]."""
    v = points[None] - apex[:, None] + 1e-8
    mod_v = torch.linalg.norm(v, dim=-1)
    alpha_x = torch.clamp(torch.sum(v * axis[:, None], dim=-1) / (mod_v + 1e-7),
                          -0.999, 0.999)
    alpha = torch.arccos(alpha_x)
    dist_angle = torch.clamp(torch.abs(alpha - theta[:, None]),
                             max=math.pi / 2.0)
    d = mod_v * torch.sin(dist_angle)
    return d * d


def sqdist_torus(points, axis, center, major_radius, minor_radius):
    """(reference: src/primitives.py:58-87) points [N, 3], axis and centre
    [..., 3], radii [...] (or floats) -> [..., N]: the smaller of the
    distances to the tube circles on both sides of the axis."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    v = points - center[..., None, :]
    z = torch.sum(v * axis[..., None, :], dim=-1)
    x = guard_sqrt(torch.sum(v * v, dim=-1) - z * z)
    big, small = (torch.as_tensor(r, dtype=points.dtype,
                                  device=points.device)[..., None]
                  for r in (major_radius, minor_radius))
    right = (guard_sqrt((x - big) ** 2 + z * z) - small) ** 2
    left = (guard_sqrt((x + big) ** 2 + z * z) - small) ** 2
    return torch.minimum(right, left)


def geom_type_from_label(label: torch.Tensor) -> torch.Tensor:
    """10-class primitive label -> geometric fit type; splines -> -1."""
    t = torch.full_like(label, -1)
    t = torch.where(label == LABEL_PLANE, GEOM_PLANE, t)
    t = torch.where(label == LABEL_SPHERE, GEOM_SPHERE, t)
    t = torch.where(label == LABEL_CYLINDER, GEOM_CYLINDER, t)
    return torch.where(label == LABEL_CONE, GEOM_CONE, t)


def residual_select(points: torch.Tensor, params: AllPrimParams,
                    geom_type: torch.Tensor) -> torch.Tensor:
    """Squared distance of every point to each segment's own primitive:
    points [N, 3], params stacked over K, geom_type [K] -> [K, N] (any type
    outside 0..3 takes the plane, which callers mask)."""
    t = geom_type[:, None]
    out = sqdist_plane(points, params.plane.normal, params.plane.offset)
    out = torch.where(t == GEOM_SPHERE,
                      sqdist_sphere(points, *params.sphere), out)
    out = torch.where(t == GEOM_CYLINDER,
                      sqdist_cylinder(points, *params.cylinder), out)
    return torch.where(t == GEOM_CONE, sqdist_cone(points, *params.cone), out)
