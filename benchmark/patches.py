"""The spline patches a SplineNet training cell is fed.

The traffic generator of the spline cells: a pool of `mix["pool_shapes"]`
patches of `mix["points"]` points, each with its control grid, made once
from RandomState(mix["pool_seed"]) (the same pool for every run, so a
window's work does not move with the seed). The trainer's own data path
(data.splines.SplineDataset) shuffles, canonicalises and augments them
from the run's seed; the reference remakes those batches with its frozen
copy (reference/plain/data/splines.py).

`make_spline_patch` is a copy of parsenet_tpu_torch/data/synthetic.py's,
draw for draw, with the training basis from the reference's frozen
B-spline module: the benchmark makes its own inputs and hands the same
ones to the program and to the reference.
"""
from __future__ import annotations

import functools

import numpy as np

from .reference.plain.ops.bspline import uniform_knot_bspline


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
        r = (1.0 + 0.3 * rng.randn(1)
             + 0.2 * np.sin(th * rng.randint(1, 4))[:, None])
        cp = np.stack([r * np.cos(th)[:, None] + 0 * z[None, :],
                       r * np.sin(th)[:, None] + 0 * z[None, :],
                       np.broadcast_to(z[None, :], (grid, grid)).copy()], -1)
    else:
        u = np.linspace(-1, 1, grid)
        uu, vv = np.meshgrid(u, u, indexing="ij")
        f = rng.rand(2) * 2 + 0.5
        hh = (0.4 * np.sin(f[0] * uu * np.pi * 0.5)
              * np.cos(f[1] * vv * np.pi * 0.5))
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


class PatchPool:
    """points [P, N, 3] f32 and control grids cps [P, G, G, 3] f32 of the
    mix's closed (mix["closed"]) or open patches; `served` counts the
    patches the run's steps took."""

    def __init__(self, mix: dict, grid: int):
        rng = np.random.RandomState(int(mix["pool_seed"]))
        out = [make_spline_patch(rng, int(mix["points"]), grid,
                                 bool(mix["closed"]))
               for _ in range(int(mix["pool_shapes"]))]
        self.points = np.stack([p for p, _ in out])
        self.cps = np.stack([c for _, c in out])
        self.size = len(out)
        self.served = 0

    def distinct_served(self) -> int:
        return min(self.served, self.size)
