"""B-spline basis matrices and surface sampling.

Counterpart of parsenet_tpu/ops/bspline.py (reference src/loss.py:142-297).
The basis matrices are constants built in numpy (NURBS Book Alg 2.4); once
they exist, evaluating a surface is one product nu @ CP @ nv^T. The
Bernstein basis and the Kronecker least-squares fit are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def basis_function_one(degree: int, knot_vector, span: int,
                       knot: float) -> float:
    """Single B-spline basis value N_{span,degree}(knot), NURBS Book Alg
    2.4 (reference: src/loss.py:242-297)."""
    kv = list(knot_vector)
    if ((span == 0 and knot == kv[0])
            or (span == len(kv) - degree - 2) and knot == kv[-1]):
        return 1.0
    if knot < kv[span] or knot >= kv[span + degree + 1]:
        return 0.0
    N = [0.0] * (degree + span + 1)
    for j in range(degree + 1):
        if kv[span + j] <= knot < kv[span + j + 1]:
            N[j] = 1.0
    for k in range(1, degree + 1):
        saved = 0.0
        if N[0] != 0.0:
            saved = ((knot - kv[span]) * N[0]) / (kv[span + k] - kv[span])
        for j in range(degree - k + 1):
            u_left = kv[span + j + 1]
            u_right = kv[span + j + k + 1]
            if N[j + 1] == 0.0:
                N[j] = saved
                saved = 0.0
            else:
                temp = N[j + 1] / (u_right - u_left)
                N[j] = saved + (u_right - knot) * temp
                saved = (knot - u_left) * temp
    return N[0]


def uniform_knots(n_ctrl: int, degree: int) -> np.ndarray:
    """Open-uniform knot vector (reference: src/loss.py:197-198)."""
    interior = np.arange(0, 1.01, 1.0 / (n_ctrl - degree)).tolist()
    return np.array([0.0] * degree + interior + [1.0] * degree)


def uniform_knot_bspline(n_ctrl_u: int, n_ctrl_v: int, degree_u: int,
                         degree_v: int, grid_size: int = 30
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Basis matrices nu [grid, n_ctrl_u], nv [grid, n_ctrl_v] f32 on the
    parameter grid u = v = arange(0, 1, 1/grid)."""
    u = np.arange(0.0, 1.0, 1.0 / grid_size)
    ku = uniform_knots(n_ctrl_u, degree_u)
    kv = uniform_knots(n_ctrl_v, degree_v)
    nu = np.zeros((u.shape[0], n_ctrl_u))
    nv = np.zeros((u.shape[0], n_ctrl_v))
    for i, ui in enumerate(u):
        for j in range(n_ctrl_u):
            nu[i, j] = basis_function_one(degree_u, ku, j, ui)
        for j in range(n_ctrl_v):
            nv[i, j] = basis_function_one(degree_v, kv, j, ui)
    return nu.astype(np.float32), nv.astype(np.float32)


def sample_surface(nu: torch.Tensor, nv: torch.Tensor,
                   cp: torch.Tensor) -> torch.Tensor:
    """Surfaces on the parameter grid, in f32. nu [Gu, U], nv [Gv, V], cp
    [..., U, V, 3] -> [..., Gu * Gv, 3]."""
    pts = torch.einsum("gu,...uvc,hv->...ghc", nu, cp, nv)
    return pts.reshape(*cp.shape[:-3], nu.shape[0] * nv.shape[0], 3)


def close_control_grid(cp: torch.Tensor) -> torch.Tensor:
    """Append the wrap-around row of a closed (u-periodic) grid
    (reference: src/primitive_forward.py:380)."""
    return torch.cat([cp, cp[..., 0:1, :, :]], dim=-3)
