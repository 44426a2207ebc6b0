"""Synthetic CAD-like shapes (numpy), the port's copy.

Same generator as parsenet_tpu/data/synthetic.py (make_shape,
make_shape_batch, make_spline_patch, make_spline_batch and the helpers they
use), draw for draw, so a RandomState seed gives bitwise-equal arrays in
both packages. Multi-segment point clouds from random planes / spheres /
cylinders / cones / spline-like height fields, with per-point segment
labels, normals and primitive types; and SplineNet training patches with
their control grids.
"""
from __future__ import annotations

import functools

import numpy as np

from ..ops.bspline import uniform_knot_bspline

# primitive taxonomy (reference: readme_data.md:36-47)
PRIM_PLANE, PRIM_OPEN_SPLINE, PRIM_CONE = 1, 2, 3
PRIM_CYLINDER, PRIM_SPHERE = 4, 5
PRIM_CLOSED_SPLINE = 9


def _unit(rng, ref=None):
    v = rng.randn(3) if ref is None else np.asarray(ref, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _frame(rng, a):
    h = rng.randn(3).astype(np.float32)
    b1 = np.cross(a, h)
    b1 /= np.linalg.norm(b1) + 1e-8
    b2 = np.cross(a, b1)
    return b1, b2


def sample_patch(rng, kind: int, n: int, center, scale: float):
    """Sample n points + normals from one primitive patch."""
    c = np.asarray(center, np.float32)
    a = _unit(rng)
    b1, b2 = _frame(rng, a)
    if kind == PRIM_PLANE:
        uv = (rng.rand(n, 2).astype(np.float32) - 0.5) * 2 * scale
        pts = c + uv[:, :1] * b1 + uv[:, 1:] * b2
        nrm = np.tile(a, (n, 1))
    elif kind == PRIM_SPHERE:
        v = rng.randn(n, 3).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = c + scale * v
        nrm = v
    elif kind == PRIM_CYLINDER:
        th = rng.rand(n).astype(np.float32) * 2 * np.pi
        h = (rng.rand(n).astype(np.float32) - 0.5) * 2 * scale
        ring = np.cos(th)[:, None] * b1 + np.sin(th)[:, None] * b2
        pts = c + 0.6 * scale * ring + h[:, None] * a
        nrm = ring
    elif kind == PRIM_CONE:
        theta = 0.3 + rng.rand() * 0.6
        phi = rng.rand(n).astype(np.float32) * 2 * np.pi
        t = (0.1 + rng.rand(n).astype(np.float32)) * scale
        ring = np.cos(phi)[:, None] * b1 + np.sin(phi)[:, None] * b2
        pts = c + t[:, None] * (np.cos(theta) * a + np.sin(theta) * ring)
        nrm = np.cos(theta) * ring - np.sin(theta) * a
    else:  # spline patch: smooth random height field over a plane frame
        uv = rng.rand(n, 2).astype(np.float32) * 2 - 1
        freq = 1 + rng.rand(2) * 2
        amp = 0.2 * scale
        h = amp * np.sin(freq[0] * np.pi * uv[:, 0]) * np.cos(freq[1] * np.pi * uv[:, 1])
        pts = c + scale * (uv[:, :1] * b1 + uv[:, 1:] * b2) + h[:, None] * a
        # analytic normal of the height field
        dhdu = amp * freq[0] * np.pi * np.cos(freq[0] * np.pi * uv[:, 0]) * np.cos(freq[1] * np.pi * uv[:, 1])
        dhdv = -amp * freq[1] * np.pi * np.sin(freq[0] * np.pi * uv[:, 0]) * np.sin(freq[1] * np.pi * uv[:, 1])
        nn = (-dhdu[:, None] * b1 - dhdv[:, None] * b2 + a) / scale
        nrm = nn / np.linalg.norm(nn, axis=1, keepdims=True)
    return pts.astype(np.float32), nrm.astype(np.float32)


def make_shape(rng: np.random.RandomState, num_points: int = 10000,
               min_segments: int = 3, max_segments: int = 12):
    """One ABC-like shape: (points [N,3], labels [N], normals [N,3], prim [N])."""
    k = rng.randint(min_segments, max_segments + 1)
    kinds = rng.choice([PRIM_PLANE, PRIM_SPHERE, PRIM_CYLINDER, PRIM_CONE,
                        PRIM_OPEN_SPLINE, PRIM_CLOSED_SPLINE], size=k,
                       p=[0.3, 0.2, 0.2, 0.1, 0.1, 0.1])
    # segment sizes: dirichlet split of the point budget, min 50 points
    w = rng.dirichlet(np.ones(k) * 2.0)
    sizes = np.maximum((w * num_points).astype(int), 50)
    sizes[-1] = num_points - sizes[:-1].sum()
    if sizes[-1] < 50:  # rebalance if the tail went negative
        sizes = np.full(k, num_points // k)
        sizes[-1] += num_points - sizes.sum()
    pts_l, nrm_l, lab_l, prim_l = [], [], [], []
    for s, (kind, sz) in enumerate(zip(kinds, sizes)):
        center = rng.randn(3) * 0.8
        scale = 0.3 + rng.rand() * 0.7
        p, nn = sample_patch(rng, int(kind), int(sz), center, scale)
        pts_l.append(p)
        nrm_l.append(nn)
        lab_l.append(np.full(sz, s, np.int32))
        prim_l.append(np.full(sz, kind, np.int32))
    points = np.concatenate(pts_l)
    normals = np.concatenate(nrm_l)
    labels = np.concatenate(lab_l)
    prim = np.concatenate(prim_l)
    perm = rng.permutation(num_points)
    return points[perm], labels[perm], normals[perm], prim[perm]


def make_shape_batch(rng, batch: int, num_points: int = 10000, **kw):
    """(points [B,N,3], labels [B,N], normals [B,N,3], prim [B,N])."""
    out = [make_shape(rng, num_points, **kw) for _ in range(batch)]
    return tuple(np.stack([o[i] for o in out]) for i in range(4))


@functools.lru_cache(maxsize=None)
def _sample_basis(grid: int):
    """The 40 x 40 sample basis of a grid (read only; built once)."""
    return uniform_knot_bspline(grid, grid, 3, 3, 40)


def make_spline_patch(rng: np.random.RandomState, num_points: int = 700,
                      grid: int = 20, closed: bool = False):
    """One SplineNet training sample: (points [N, 3], control grid
    [G, G, 3]): a random smooth control grid (wrapped around a cylinder-like
    shape when closed) and points drawn from its surface, sampled with the
    training basis, plus a little jitter."""
    if closed:
        th = np.linspace(0, 2 * np.pi, grid, endpoint=False)
        z = np.linspace(-1, 1, grid)
        r = 1.0 + 0.3 * rng.randn(1) + 0.2 * np.sin(th * rng.randint(1, 4))[:, None]
        cp = np.stack([r * np.cos(th)[:, None] + 0 * z[None, :],
                       r * np.sin(th)[:, None] + 0 * z[None, :],
                       np.broadcast_to(z[None, :], (grid, grid)).copy()], -1)
    else:
        u = np.linspace(-1, 1, grid)
        uu, vv = np.meshgrid(u, u, indexing="ij")
        f = rng.rand(2) * 2 + 0.5
        hh = 0.4 * np.sin(f[0] * uu * np.pi * 0.5) * np.cos(f[1] * vv * np.pi * 0.5)
        hh += 0.1 * rng.randn(grid, grid)
        hh = 0.25 * (np.roll(hh, 1, 0) + np.roll(hh, -1, 0)
                     + np.roll(hh, 1, 1) + np.roll(hh, -1, 1))
        cp = np.stack([uu, vv, hh], -1)
    cp = cp.astype(np.float32)
    nu, nv = _sample_basis(grid)
    surf = np.einsum("gu,uvc,hv->ghc", nu, cp, nv).reshape(-1, 3)
    idx = rng.randint(0, surf.shape[0], num_points)
    jitter = rng.randn(num_points, 3).astype(np.float32) * 0.002
    return (surf[idx] + jitter).astype(np.float32), cp


def make_spline_batch(rng, batch: int, num_points: int = 700, grid: int = 20,
                      closed: bool = False):
    pts, cps = [], []
    for _ in range(batch):
        p, c = make_spline_patch(rng, num_points, grid, closed)
        pts.append(p)
        cps.append(c)
    return np.stack(pts), np.stack(cps)
