"""Regular parameter-grid samples on fitted primitive surfaces.

Counterpart of parsenet_tpu/ops/sampling.py (reference
src/primitive_forward.py:427-693): plane, sphere cap, cylinder and cone
grids trimmed to the extent of each segment. Every sampler takes the
parameters of K segments, the shape's points [N, 3] and the segment masks
[K, N], and returns [K, grid * grid, 3]; `fibonacci_sphere` covers whole
spheres and takes no segment.
"""
from __future__ import annotations

import math

import torch

from ..core.guards import EPS


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + EPS)


def _orthonormal_frame(a: torch.Tensor):
    """Two unit vectors spanning the plane normal to each unit a [K, 3]."""
    ex = torch.tensor([1.0, 0.0, 0.0], device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=a.device)
    h = torch.where((torch.abs(a[:, 0]) < 0.9)[:, None], ex, ey)
    b1 = _normalize(torch.linalg.cross(a, h))
    return b1, torch.linalg.cross(a, b1)


def _extent(vals: torch.Tensor, mask: torch.Tensor):
    """Masked (min, max) over the last axis: [K, N] -> [K], [K]."""
    lo = torch.amin(torch.where(mask > 0, vals, 1e9), dim=-1)
    hi = torch.amax(torch.where(mask > 0, vals, -1e9), dim=-1)
    return lo, hi


def _grid01(grid: int, device) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, grid, device=device)


def _ring(grid: int, device) -> torch.Tensor:
    """grid angles over [0, 2 pi) (endpoint excluded)."""
    return torch.linspace(0.0, 2.0 * math.pi, grid + 1, device=device)[:grid]


def _mesh(u: torch.Tensor, v: torch.Tensor):
    """ij meshgrid of per-segment axes u [K, g], v [K or 1, g] -> flat
    [K, g*g] each."""
    g = u.shape[-1]
    U = u[:, :, None].expand(-1, g, g)
    V = v[:, None, :].expand(u.shape[0], g, g)
    return U.reshape(u.shape[0], -1), V.reshape(u.shape[0], -1)


def sample_plane(normal, offset, seg_points, seg_mask, grid: int = 32):
    """Grid on each fitted plane covering its segment's box."""
    a = _normalize(normal)
    b1, b2 = _orthonormal_frame(a)
    ulo, uhi = _extent(b1 @ seg_points.T, seg_mask)
    vlo, vhi = _extent(b2 @ seg_points.T, seg_mask)
    t = _grid01(grid, a.device)
    U, V = _mesh(ulo[:, None] + (uhi - ulo)[:, None] * t,
                 vlo[:, None] + (vhi - vlo)[:, None] * t)
    return ((offset[:, None, None] * a[:, None, :])
            + U[..., None] * b1[:, None, :] + V[..., None] * b2[:, None, :])


def sample_sphere(center, radius, seg_points, seg_mask, grid: int = 32):
    """Polar grid over the spherical cap that the segment spans: around
    its members' mean direction, up to their largest angular radius."""
    dn = _normalize(seg_points[None] - center[:, None])          # [K, N, 3]
    m = _normalize(torch.sum(dn * (seg_mask[..., None] > 0), dim=1))
    cmin = torch.amin(torch.where(seg_mask > 0,
                                  torch.sum(dn * m[:, None], dim=-1), 1.0),
                      dim=-1)
    alpha = torch.clamp(torch.arccos(torch.clamp(cmin, -1.0, 1.0)),
                        0.05, math.pi)
    b1, b2 = _orthonormal_frame(m)
    TH, PH = _mesh(_grid01(grid, m.device)[None] * alpha[:, None],
                   _ring(grid, m.device)[None])
    dirs = (torch.cos(TH)[..., None] * m[:, None]
            + (torch.sin(TH) * torch.cos(PH))[..., None] * b1[:, None]
            + (torch.sin(TH) * torch.sin(PH))[..., None] * b2[:, None])
    return center[:, None] + radius[:, None, None] * dirs


def fibonacci_sphere(center, radius, grid: int = 32):
    """grid * grid samples over each whole sphere [K], Fibonacci-spaced (no
    pole clustering): the JAX package's sample_sphere without a segment."""
    i = torch.arange(grid * grid, dtype=torch.float32, device=center.device)
    ga = math.pi * (3.0 - math.sqrt(5.0))
    z = 1.0 - 2.0 * (i + 0.5) / (grid * grid)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    th = ga * i
    d = torch.stack([r * torch.cos(th), r * torch.sin(th), z], dim=1)
    return center[:, None] + radius[:, None, None] * d


def sample_cylinder(axis, center, radius, seg_points, seg_mask,
                    grid: int = 32):
    """Cylinder grid over each segment's axial extent."""
    a = _normalize(axis)
    b1, b2 = _orthonormal_frame(a)
    h = torch.sum((seg_points[None] - center[:, None]) * a[:, None], dim=-1)
    hlo, hhi = _extent(h, seg_mask)
    H, TH = _mesh(hlo[:, None] + (hhi - hlo)[:, None] * _grid01(grid, a.device),
                  _ring(grid, a.device)[None])
    ring = (torch.cos(TH)[..., None] * b1[:, None]
            + torch.sin(TH)[..., None] * b2[:, None])
    return (center[:, None] + radius[:, None, None] * ring
            + H[..., None] * a[:, None])


def sample_cone(apex, axis, theta, seg_points, seg_mask, grid: int = 32):
    """Cone grid over each segment's extent along the axis."""
    a = _normalize(axis)
    b1, b2 = _orthonormal_frame(a)
    s = torch.sum((seg_points[None] - apex[:, None]) * a[:, None], dim=-1)
    slo, shi = _extent(s, seg_mask)
    S, TH = _mesh(slo[:, None] + (shi - slo)[:, None] * _grid01(grid, a.device),
                  _ring(grid, a.device)[None])
    rad = torch.abs(S) * torch.tan(theta)[:, None]
    ring = (torch.cos(TH)[..., None] * b1[:, None]
            + torch.sin(TH)[..., None] * b2[:, None])
    return (apex[:, None] + S[..., None] * a[:, None]
            + rad[..., None] * ring)


def sample_torus(axis, center, major_radius, minor_radius, grid: int = 32):
    """grid x grid samples over each whole torus [K] (axis [K, 3], center
    [K, 3], radii [K]; reference src/primitive_forward.py:427-450): the
    tube angle v around the ring angle u, row-major in (u, v) ->
    [K, grid^2, 3]."""
    a = _normalize(axis)
    b1, b2 = _orthonormal_frame(a)
    U, V = _mesh(_ring(grid, a.device)[None].expand(a.shape[0], -1),
                 _ring(grid, a.device)[None])
    ring = (torch.cos(U)[..., None] * b1[:, None]
            + torch.sin(U)[..., None] * b2[:, None])
    r = major_radius[:, None] + minor_radius[:, None] * torch.cos(V)
    z = minor_radius[:, None] * torch.sin(V)
    return center[:, None] + r[..., None] * ring + z[..., None] * a[:, None]


def project_to_plane(points: torch.Tensor, normal: torch.Tensor,
                     offset) -> torch.Tensor:
    """points [N, 3] projected onto the plane <normal, p> = offset
    (reference src/fitting_utils.py:625-634)."""
    a = normal / (torch.linalg.norm(normal) + EPS)
    prj = points - (points @ a)[:, None] * a[None, :]
    return prj + a[None, :] * offset


def project_to_point_cloud(points: torch.Tensor,
                           surface: torch.Tensor) -> torch.Tensor:
    """Each point of points [N, 3] snapped to its nearest sample of surface
    [M, 3] (reference src/fitting_utils.py:637-643): the first argmin of
    the squared distance, K3 (kernels.min_sqdist_with_idx) on the card."""
    from .kernels import min_sqdist_with_idx
    with torch.no_grad():
        idx = min_sqdist_with_idx(points.contiguous(), surface.contiguous())[1]
    return surface[idx.to(torch.int64)]
