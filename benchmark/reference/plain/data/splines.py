"""The SplineNet training feed: the split, the shuffle, the
canonicalisation and the augmentation of the spline patches (host-side
numpy).

The benchmark's frozen copy of the port's data/splines.py (SplineDataset's
split and training generator, `canon_batch`), data/augment.py (`Augment`)
and data/abc.py (`align_canonical`), draw for draw: the same patches and
seed give the same batches. The split's fixed shuffle draws from
RandomState(0), which is what the port's `np.random.seed(0)` followed by
`np.random.shuffle` draws from, without touching numpy's global state.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

EPS = np.finfo(np.float32).eps


def pca_numpy(points: np.ndarray):
    """Eigendecomposition of the covariance."""
    S, U = np.linalg.eig(points.T @ points)
    return S, U


def rotation_matrix_a_to_b(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Rotation with R @ A = B."""
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


def alignment(points: np.ndarray) -> np.ndarray:
    """The rotation of align_canonical: the minor principal axis onto x."""
    S, U = pca_numpy(points)
    smallest_ev = U[:, np.argmin(S)].real.astype(np.float32)
    return rotation_matrix_a_to_b(smallest_ev,
                                  np.array([1.0, 0, 0], np.float32))


def canon_batch(pts: np.ndarray, cps: np.ndarray, align: bool,
                anisotropic: bool, augmentor=None):
    """Canonicalise a batch of patches: points [B, N, 3] and their control
    grids [B, G, G, 3] -> (points, grids, scales [B, 3], rotations
    [B, 3, 3]); the augmentor, if any, then perturbs the points."""
    B = pts.shape[0]
    out_p = np.empty_like(pts)
    out_c = np.empty_like(cps)
    scales = np.empty((B, 3), np.float32)
    Rs = np.empty((B, 3, 3), np.float32)
    G = cps.shape[1]
    for i in range(B):
        p = pts[i]
        mean = p.mean(0, keepdims=True)
        p = p - mean
        c = cps[i] - mean.reshape(1, 1, 3)
        R = np.eye(3, dtype=np.float32)
        if align:
            R = alignment(p)
            p = (R @ (pts[i] - mean).T).T
            c = (R @ c.reshape(-1, 3).T).T.reshape(G, G, 3)
        if anisotropic:
            std = np.abs(p.max(0) - p.min(0)).reshape(1, 3)
            p = p / (std + EPS)
            c = c / (std.reshape(1, 1, 3) + EPS)
            scales[i] = std
        else:
            std = float((p.max(0) - p.min(0)).max())
            p = p / std
            c = c / std
            scales[i] = std
        out_p[i], out_c[i], Rs[i] = p, c, R
    if augmentor is not None:
        out_p = augmentor.augment(out_p)
    return out_p.astype(np.float32), out_c.astype(np.float32), scales, Rs


def rotate_point_cloud(batch: np.ndarray, rng) -> np.ndarray:
    """Random yaw rotation per batch item."""
    out = np.empty_like(batch)
    for k in range(batch.shape[0]):
        angle = rng.uniform() * 2 * np.pi
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], batch.dtype)
        out[k] = batch[k] @ R
    return out


def rotate_perturbation_point_cloud(batch: np.ndarray, rng,
                                    angle_sigma: float = 0.06,
                                    angle_clip: float = 0.18) -> np.ndarray:
    """Small random SO(3) perturbation per batch item."""
    out = np.empty_like(batch)
    for k in range(batch.shape[0]):
        angles = np.clip(angle_sigma * rng.randn(3), -angle_clip, angle_clip)
        cx, sx = np.cos(angles[0]), np.sin(angles[0])
        cy, sy = np.cos(angles[1]), np.sin(angles[1])
        cz, sz = np.cos(angles[2]), np.sin(angles[2])
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R = (Rz @ Ry @ Rx).astype(batch.dtype)
        out[k] = batch[k] @ R
    return out


def jitter_point_cloud(batch: np.ndarray, rng, sigma: float = 0.01,
                       clip: float = 0.05) -> np.ndarray:
    noise = np.clip(sigma * rng.randn(*batch.shape), -clip, clip)
    return batch + noise.astype(batch.dtype)


def shift_point_cloud(batch: np.ndarray, rng,
                      shift_range: float = 0.1) -> np.ndarray:
    shifts = rng.uniform(-shift_range, shift_range,
                         (batch.shape[0], 1, 3)).astype(batch.dtype)
    return batch + shifts


def random_scale_point_cloud(batch: np.ndarray, rng,
                             scale_low: float = 0.8,
                             scale_high: float = 1.2) -> np.ndarray:
    scales = rng.uniform(scale_low, scale_high,
                         (batch.shape[0], 1, 1)).astype(batch.dtype)
    return batch * scales


AUGMENT_ROUTINES = (rotate_perturbation_point_cloud, jitter_point_cloud,
                    shift_point_cloud, random_scale_point_cloud,
                    rotate_point_cloud)


class Augment:
    """Apply each augmentation with probability `prob` (0.3)."""

    def __init__(self, seed: int = 0, prob: float = 0.3):
        self.rng = np.random.RandomState(seed)
        self.prob = prob

    def augment(self, batch: np.ndarray) -> np.ndarray:
        for fn in AUGMENT_ROUTINES:
            if self.rng.uniform() < self.prob:
                batch = fn(batch, self.rng)
        return batch.astype(np.float32)


def train_batches(points: np.ndarray, cps: np.ndarray, batch_size: int,
                  seed: int, n_train: Optional[int] = None,
                  anisotropic: bool = True) -> Iterator:
    """SplineDataset(points, cps, ..., seed, splits=(n_train, ...))'s
    load_train_data(anisotropic=anisotropic, if_augment=True): the first
    n_train patches of the fixed shuffle, reshuffled every epoch by
    RandomState(seed), each batch PCA-aligned, scaled and augmented by
    Augment(seed) -> (points, cps, scales, rotations) numpy."""
    order = np.arange(points.shape[0])
    np.random.RandomState(0).shuffle(order)
    n = min(points.shape[0] if n_train is None else n_train,
            points.shape[0])
    pts, cp = points[order][:n], cps[order][:n]
    rng, augmentor = np.random.RandomState(seed), Augment(seed=seed)
    while True:
        idx = np.arange(n)
        rng.shuffle(idx)
        for b in range(max(n // batch_size - 1, 1)):
            sel = idx[b * batch_size:(b + 1) * batch_size]
            yield canon_batch(pts[sel], cp[sel], True, anisotropic,
                              augmentor)
