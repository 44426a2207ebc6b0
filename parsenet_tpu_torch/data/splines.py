"""Spline-patch batches for SplineNet training (host-side numpy).

Counterpart of parsenet_tpu/data/splines.py (reference src/dataset.py:
28-269, DataSetControlPointsPoisson): an h5 of points [S, N, 3] and
controlpoints [S, G, G, 3], fixed shuffled splits (open 50k / 10k / rest,
closed 28k / 3k / rest), and per batch `canon_batch`: mean-centring, PCA
alignment and per-axis (anisotropic) or uniform bbox scaling, optionally
augmented. `synthetic_batches` runs the same canonicalisation over
`data.synthetic.make_spline_batch` patches. Batches are numpy tuples
(points, controlpoints, scales, rotations). `SplineDataset` takes the
patches from an h5 or from arrays; h5py is imported only when an h5 is
read.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .augment import Augment, align_canonical
from .synthetic import make_spline_batch

EPS = np.finfo(np.float32).eps


def canon_batch(pts: np.ndarray, cps: np.ndarray, align: bool,
                anisotropic: bool, augmentor: Optional[Augment] = None):
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
            # align_canonical also scales; only its rotation is kept, and
            # the scale is taken below from the rotated raw points
            _, _, R, _ = align_canonical(p, None, anisotropic=False)
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


def synthetic_batches(rng: np.random.RandomState, batch_size: int,
                      num_points: int = 700, grid: int = 20,
                      closed: bool = False) -> Iterator:
    """Endless canonicalised batches of synthetic patches from `rng`,
    PCA-aligned and scaled per axis as the training data is."""
    while True:
        pts, cps = make_spline_batch(rng, batch_size, num_points, grid,
                                     closed)
        yield canon_batch(pts, cps, True, True)


class SplineDataset:
    """Patches split, shuffled and canonicalised as the reference's loader
    does. `SplineDataset(path, ...)` reads an h5 (points [S, N, 3],
    controlpoints [S, G, G, 3]); `SplineDataset.from_arrays(points, cps,
    ...)` takes the same arrays from memory. Either way the patches go
    through the fixed split, the per-epoch shuffle, `canon_batch` and
    `Augment`."""

    def __init__(self, path: str, batch_size: int, grid: int = 20,
                 closed: bool = False, seed: int = 0,
                 splits: Optional[Tuple[int, int]] = None):
        import h5py
        with h5py.File(path, "r") as hf:
            points = np.array(hf.get("points")).astype(np.float32)
            cps = np.array(hf.get("controlpoints")).astype(np.float32)
        self._split(points, cps, batch_size, grid, closed, seed, splits)

    @classmethod
    def from_arrays(cls, points: np.ndarray, cps: np.ndarray,
                    batch_size: int, grid: int = 20, closed: bool = False,
                    seed: int = 0,
                    splits: Optional[Tuple[int, int]] = None
                    ) -> "SplineDataset":
        """The dataset of in-memory patches: points [S, N, 3] and their
        control grids [S, G, G, 3], as an h5 would hold them."""
        ds = cls.__new__(cls)
        ds._split(np.asarray(points, np.float32), np.asarray(cps, np.float32),
                  batch_size, grid, closed, seed, splits)
        return ds

    def _split(self, points, cps, batch_size, grid, closed, seed, splits):
        self.batch_size = batch_size
        self.grid = grid
        self.closed = closed
        self.rng = np.random.RandomState(seed)
        self.augmentor = Augment(seed=seed)
        # the reference's fixed shuffled split (src/dataset.py:54-75),
        # through numpy's global seed as there
        np.random.seed(0)
        order = np.arange(points.shape[0])
        np.random.shuffle(order)
        points, cps = points[order], cps[order]
        if splits is None:
            splits = (28000, 3000) if closed else (50000, 10000)
        n_train, n_val = splits
        n_train = min(n_train, points.shape[0])
        n_val = min(n_val, max(points.shape[0] - n_train, 0))
        self.train_points = points[:n_train]
        self.train_cps = cps[:n_train]
        self.val_points = points[n_train:n_train + n_val]
        self.val_cps = cps[n_train:n_train + n_val]
        self.test_points = points[n_train + n_val:]
        self.test_cps = cps[n_train + n_val:]

    def _gen(self, pts, cps, align, anisotropic, if_augment,
             randomize) -> Iterator:
        n = pts.shape[0]
        bs = self.batch_size
        if n < bs:
            raise ValueError(f"split has {n} patches < batch size {bs}; "
                             f"check the dataset split sizes")
        augmentor = self.augmentor if if_augment else None
        while True:
            order = np.arange(n)
            if randomize:
                self.rng.shuffle(order)
            for b in range(max(n // bs - 1, 1)):
                sel = order[b * bs:(b + 1) * bs]
                yield canon_batch(pts[sel], cps[sel], align, anisotropic,
                                  augmentor)

    def load_train_data(self, align_canonical: bool = True,
                        anisotropic: bool = True, if_augment: bool = False):
        return self._gen(self.train_points, self.train_cps, align_canonical,
                         anisotropic, if_augment, randomize=True)

    def load_val_data(self, align_canonical: bool = True,
                      anisotropic: bool = True, if_augment: bool = False):
        return self._gen(self.val_points, self.val_cps, align_canonical,
                         anisotropic, if_augment, randomize=False)

    def load_test_data(self, align_canonical: bool = True,
                       anisotropic: bool = True):
        return self._gen(self.test_points, self.test_cps, align_canonical,
                         anisotropic, False, randomize=False)
