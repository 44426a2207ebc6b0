"""The shapes every cell is fed, and the order they are served in.

The traffic generator: a cell's mix (benchmark/mixes/<traffic>.json) gives
the points a shape, the shapes a request (a batch or an optimizer step),
the points a training step keeps of each shape, and the size and seed of
the pool of distinct shapes, which set-up makes. Requests take the pool's
shapes in an order drawn from the run's seed, round and round where a
window outruns the pool.

The shape synthesis (`make_shape` and its helpers) and the canonicalisation
(`normalize_points`) are copies of parsenet_tpu_torch/data/synthetic.py and
data/abc.py, draw for draw: the benchmark makes its own inputs and hands
the same ones to the program and to the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

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


def pca_numpy(points: np.ndarray):
    """Eigendecomposition of the covariance."""
    S, U = np.linalg.eig(points.T @ points)
    return S, U


def rotation_matrix_a_to_b(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Rotation with R @ A = B."""
    EPS = np.finfo(np.float32).eps
    cos = np.dot(A, B)
    sin = np.linalg.norm(np.cross(B, A))
    u = A
    v = B - np.dot(A, B) * A
    v = v / (np.linalg.norm(v) + EPS)
    w = np.cross(B, A)
    w = w / (np.linalg.norm(w) + EPS)
    F = np.stack([u, v, w], 1)
    G = np.array([[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]])
    try:
        R = F @ G @ np.linalg.inv(F)
    except np.linalg.LinAlgError:
        R = np.eye(3, dtype=np.float32)
    return R.astype(np.float32)


def align_canonical(points: np.ndarray, normals: Optional[np.ndarray] = None,
                    anisotropic: bool = False):
    """Rotate the minor principal axis onto x and normalise by the bbox
    extent. Returns (points, normals, R, std)."""
    EPS = np.finfo(np.float32).eps
    S, U = pca_numpy(points)
    smallest_ev = U[:, np.argmin(S)].real.astype(np.float32)
    R = rotation_matrix_a_to_b(smallest_ev, np.array([1.0, 0, 0], np.float32))
    points = (R @ points.T).T
    if normals is not None:
        normals = (R @ normals.T).T
    std = np.max(points, 0) - np.min(points, 0)
    if anisotropic:
        points = points / (std.reshape(1, 3) + EPS)
    else:
        points = points / (np.max(std) + EPS)
    return points.astype(np.float32), normals, R, std.astype(np.float32)


def normalize_points(points: np.ndarray, normals: Optional[np.ndarray] = None,
                     anisotropic: bool = False):
    """Single-shape canonicalisation for eval. Returns (points, normals, R,
    std) as align_canonical does."""
    points = points - points.mean(0, keepdims=True)
    return align_canonical(points, normals, anisotropic)


class ShapePool:
    """`mix["pool_shapes"]` shapes of `mix["points"]` points from
    RandomState(mix["pool_seed"]), each canonicalised as ABCDataset.get_test
    feeds the network: points [P, N, 3] f32, labels [P, N] int32, normals
    [P, N, 3] f32, prim [P, N] int32. The pool is the mix's, the same for
    every run, so every seed serves the same shapes and a window's work
    does not move with the seed; `order`, the order they are served in, is
    drawn from the run's seed."""

    def __init__(self, mix: dict, seed: int):
        rng = np.random.RandomState(int(mix["pool_seed"]))
        n_pool, n_pts = int(mix["pool_shapes"]), int(mix["points"])
        out = [make_shape(rng, n_pts) for _ in range(n_pool)]
        self.points, self.labels, self.normals, self.prim = (
            np.stack([o[i] for o in out]) for i in range(4))
        for i in range(n_pool):
            p, nrm, _, _ = normalize_points(self.points[i], self.normals[i])
            self.points[i], self.normals[i] = p, nrm
        self.points = self.points.astype(np.float32)
        self.normals = self.normals.astype(np.float32)
        self.order = np.random.RandomState(seed).permutation(n_pool)
        self.size = n_pool
        self.served = 0

    def take(self, count: int) -> np.ndarray:
        """The pool indices of the next `count` shapes served."""
        pos = (self.served + np.arange(count)) % self.size
        self.served += count
        return self.order[pos]

    def distinct_served(self) -> int:
        return min(self.served, self.size)

    def batch(self, idx: np.ndarray):
        """(points, labels, normals, prim) numpy of the shapes `idx`."""
        return (self.points[idx], self.labels[idx], self.normals[idx],
                self.prim[idx])
