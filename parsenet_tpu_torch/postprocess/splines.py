"""Classical spline post-optimization (host-side numpy + native LAP/ARAP).

Implements the reference's eval-time refinement
(src/primitive_forward.py:105-344): sample the predicted spline surface at
fixed parameters, establish a 1-1 correspondence to (upsampled) input points
with the exact LAP solver, then least-squares refit a fresh control grid at
those parameters (the "kronecker" variant, src/approximation.py:338-364),
optionally preceded by an ARAP deformation of the sampled surface toward the
inputs (src/fitting_optimization.py:32-114). A numpy copy of
parsenet_tpu/postprocess/splines.py over the port's own native binding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import cpp as native
from ..ops.bspline import basis_matrix_at, regular_parameterization


def up_sample_points(points: np.ndarray, times: int = 1) -> np.ndarray:
    """Double the point set by averaging each point with a random neighbour
    (reference: src/fitting_utils.py:109-237)."""
    rng = np.random.RandomState(0)
    for _ in range(times):
        n = points.shape[0]
        d = ((points[:, None] - points[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        k = min(3, n - 1)
        nbrs = np.argpartition(d, k - 1, axis=1)[:, :k]
        pick = nbrs[np.arange(n), rng.randint(0, k, n)]
        mid = 0.5 * (points + points[pick])
        points = np.concatenate([points, mid], 0)
    return points


def up_sample_points_in_range(points: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Upsample (or subsample) into [lo, hi] points
    (reference: src/fitting_utils.py:218-237)."""
    rng = np.random.RandomState(0)
    while points.shape[0] < lo:
        points = up_sample_points(points)
    if points.shape[0] > hi:
        sel = rng.choice(points.shape[0], hi, replace=False)
        points = points[sel]
    return points


def optimize_spline_kronecker(surface_points: np.ndarray,
                              input_points: np.ndarray,
                              closed: bool = False,
                              grid_u: int = 30, grid_v: int = 30,
                              new_cp_size: int = 10, new_degree: int = 3,
                              deform: bool = False,
                              triangles: Optional[np.ndarray] = None,
                              eval_grid: Tuple[int, int] = (40, 40)
                              ) -> np.ndarray:
    """Refit the predicted surface to the input segment.

    surface_points: [grid_u * grid_v, 3] samples of the predicted spline on
    the regular parameter grid; input_points: [M, 3] segment points.
    Returns refined surface samples on an `eval_grid` parameterization.
    """
    params = regular_parameterization(grid_u, grid_v)  # [G, 2]
    pts = np.asarray(surface_points, np.float32).reshape(-1, 3)

    if deform and triangles is not None:
        # ARAP: pull boundary/nearest handles toward the inputs first
        # (reference deforms with the matched correspondence as handles)
        d = ((pts[:, None] - input_points[None]) ** 2).sum(-1)
        handle_idx = np.arange(0, pts.shape[0],
                               max(pts.shape[0] // 100, 1), dtype=np.int32)
        handle_pos = input_points[np.argmin(d[handle_idx], axis=1)]
        pts = native.arap_deform(pts, triangles, handle_idx,
                                 handle_pos.astype(np.float32), max_iter=20)

    target = up_sample_points_in_range(np.asarray(input_points, np.float32),
                                       len(pts), len(pts) + 200)
    # 1-1 correspondence surface-sample -> input point (square LAP on the
    # first len(pts) targets, reference pads with upsampling the same way)
    target = target[:len(pts)]
    dist = np.linalg.norm(pts[:, None] - target[None], axis=2)
    _, cids = native.solve_dense(dist)
    matched = target[cids]

    # least-squares control grid at the sample parameters
    nu_p = basis_matrix_at(params[:, 0], new_cp_size, new_degree)
    nv_p = basis_matrix_at(params[:, 1], new_cp_size, new_degree)
    A = (nu_p[:, :, None] * nv_p[:, None, :]).reshape(len(params), -1)
    AtA = A.T @ A + 1e-7 * np.eye(A.shape[1])
    cp = np.linalg.solve(AtA, A.T @ matched).astype(np.float32)
    cp = cp.reshape(new_cp_size, new_cp_size, 3)

    out_params = regular_parameterization(*eval_grid)
    nu_e = basis_matrix_at(out_params[:, 0], new_cp_size, new_degree)
    nv_e = basis_matrix_at(out_params[:, 1], new_cp_size, new_degree)
    return np.einsum("mu,uvc,mv->mc", nu_e, cp, nv_e).astype(np.float32)
