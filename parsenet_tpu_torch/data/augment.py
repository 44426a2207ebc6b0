"""Point-cloud augmentations (host-side numpy), the port's copy.

Counterpart of parsenet_tpu/data/augment.py (reference
src/augment_utils.py:7-128), draw for draw: the same RandomState gives the
same augmented batch. `align_canonical` is data/abc's, which the tests hold
equal to the JAX package's data/augment.align_canonical.
"""
from __future__ import annotations

import numpy as np

from .abc import align_canonical  # noqa: F401  (re-exported)


def rotate_point_cloud(batch: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Random yaw rotation per batch item."""
    out = np.empty_like(batch)
    for k in range(batch.shape[0]):
        angle = rng.uniform() * 2 * np.pi
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], batch.dtype)
        out[k] = batch[k] @ R
    return out


def rotate_perturbation_point_cloud(batch: np.ndarray, rng: np.random.RandomState,
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


def jitter_point_cloud(batch: np.ndarray, rng: np.random.RandomState,
                       sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    noise = np.clip(sigma * rng.randn(*batch.shape), -clip, clip)
    return batch + noise.astype(batch.dtype)


def shift_point_cloud(batch: np.ndarray, rng: np.random.RandomState,
                      shift_range: float = 0.1) -> np.ndarray:
    shifts = rng.uniform(-shift_range, shift_range,
                         (batch.shape[0], 1, 3)).astype(batch.dtype)
    return batch + shifts


def random_scale_point_cloud(batch: np.ndarray, rng: np.random.RandomState,
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
