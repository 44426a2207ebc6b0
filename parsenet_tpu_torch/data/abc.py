"""The ABC segmentation dataset and the canonicalisation of one shape
(numpy), the port's copy.

Counterpart of parsenet_tpu/data/abc.py (reference src/dataset_segments.py)
with its own copy of data/augment.align_canonical and the helpers it uses:
mean-centre, rotate the minor principal axis onto x, scale by the
bounding-box extent (reference: src/dataset_segments.py:127-144, 257-302).
`ABCDataset` reads the h5 splits (points [S, N, 3], labels [S, N], normals,
prim) with h5py, imported when a dataset is opened; a missing file raises.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

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


@dataclasses.dataclass
class Split:
    points: np.ndarray    # [S, N, 3] mean-centred
    labels: np.ndarray    # [S, N] int
    normals: Optional[np.ndarray]
    prim: Optional[np.ndarray]

    @property
    def size(self) -> int:
        return self.points.shape[0]


def _load_h5(path: str, size: Optional[int], normals: bool,
             primitives: bool) -> Split:
    import h5py
    with h5py.File(path, "r") as hf:
        points = np.array(hf.get("points"))[:size].astype(np.float32)
        labels = np.array(hf.get("labels"))[:size].astype(np.int64)
        nrm = (np.array(hf.get("normals"))[:size].astype(np.float32)
               if normals else None)
        prim = (np.array(hf.get("prim"))[:size].astype(np.int64)
                if primitives else None)
    return Split(points - points.mean(1, keepdims=True), labels, nrm, prim)


class ABCDataset:
    """The train / val / test splits of {path_prefix}{train,val,test}_data.h5
    and endless batch generators over them, draw for draw the JAX
    package's (reference: src/dataset_segments.py:14-255)."""

    def __init__(self, batch_size: int, path_prefix: str = "data/shapes/",
                 train_size: Optional[int] = None,
                 val_size: Optional[int] = None,
                 test_size: Optional[int] = None, normals: bool = True,
                 primitives: bool = True, if_train_data: bool = True,
                 seed: int = 0):
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.train = (_load_h5(path_prefix + "train_data.h5", train_size,
                               normals, primitives) if if_train_data else None)
        self.val = _load_h5(path_prefix + "val_data.h5", val_size, normals,
                            primitives)
        self.test = _load_h5(path_prefix + "test_data.h5", test_size,
                             normals, primitives)

    def _batches(self, split: Split, randomize: bool, augment: bool,
                 anisotropic: bool, align: bool, if_normal_noise: bool,
                 loop: bool, batch_size: Optional[int] = None
                 ) -> Iterator[Tuple]:
        from .augment import AUGMENT_ROUTINES
        n, bs = split.size, batch_size or self.batch_size
        if n < bs:
            raise ValueError(f"split has {n} shapes < batch size {bs}; an "
                             f"endless generator would never yield")
        while True:
            order = np.arange(n)
            if randomize:
                self.rng.shuffle(order)
            for i in range(n // bs):
                sel = order[i * bs:(i + 1) * bs]
                points = split.points[sel].copy()
                labels = split.labels[sel]
                nrm = (split.normals[sel].copy()
                       if split.normals is not None else None)
                prim = split.prim[sel] if split.prim is not None else None
                if augment:
                    fn = AUGMENT_ROUTINES[self.rng.choice(
                        len(AUGMENT_ROUTINES))]
                    points = fn(points, self.rng)
                if if_normal_noise and nrm is not None:
                    noise = nrm * np.clip(
                        self.rng.randn(1, points.shape[1], 1) * 0.01,
                        -0.01, 0.01)
                    points = (points + noise).astype(np.float32)
                if align:
                    for j in range(bs):
                        pj, nj, _, _ = align_canonical(
                            points[j], None if nrm is None else nrm[j],
                            anisotropic)
                        points[j] = pj
                        if nj is not None:
                            nrm[j] = nj
                yield points.astype(np.float32), labels, nrm, prim
            if not loop:
                return

    def get_train(self, randomize: bool = True, augment: bool = True,
                  anisotropic: bool = False, align_canonical: bool = True,
                  if_normal_noise: bool = True,
                  batch_size: Optional[int] = None):
        return self._batches(self.train, randomize, augment, anisotropic,
                             align_canonical, if_normal_noise, loop=True,
                             batch_size=batch_size)

    def get_val(self, align_canonical: bool = True, anisotropic: bool = False,
                if_normal_noise: bool = True,
                batch_size: Optional[int] = None):
        return self._batches(self.val, False, False, anisotropic,
                             align_canonical, if_normal_noise, loop=True,
                             batch_size=batch_size)

    def get_test(self, align_canonical: bool = True, anisotropic: bool = False,
                 loop: bool = False, batch_size: Optional[int] = None):
        return self._batches(self.test, False, False, anisotropic,
                             align_canonical, False, loop=loop,
                             batch_size=batch_size or 1)


def normalize_points(points: np.ndarray, normals: Optional[np.ndarray] = None,
                     anisotropic: bool = False):
    """Single-shape canonicalisation for eval. Returns (points, normals, R,
    std) as align_canonical does."""
    points = points - points.mean(0, keepdims=True)
    return align_canonical(points, normals, anisotropic)
