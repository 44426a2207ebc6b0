"""Eval-mode canonicalisation of one shape (numpy), the port's copy.

Counterpart of parsenet_tpu/data/abc.normalize_points with its own copy of
data/augment.align_canonical and the helpers it uses: mean-centre, rotate
the minor principal axis onto x, scale by the bounding-box extent
(reference: src/dataset_segments.py:127-144, 257-302).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


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
