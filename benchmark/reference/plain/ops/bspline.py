"""B-spline / Bezier basis matrices, surface sampling and the Kronecker
least-squares fit.

Counterpart of parsenet_tpu/ops/bspline.py (reference src/loss.py:142-297,
src/approximation.py:288-364). The basis matrices are constants built in
numpy (NURBS Book Alg 2.4); once they exist, evaluating a surface is one
product nu @ CP @ nv^T, and refitting a control grid to scattered points
one ridge solve of the normal equations of A_i = nu_i (x) nv_i.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..core.guards import set_fp32_policy


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


def basis_matrix_at(params: np.ndarray, n_ctrl: int,
                    degree: int) -> np.ndarray:
    """Basis matrix f32 at arbitrary parameter values [M] -> [M, n_ctrl]
    (open-uniform knots)."""
    kv = uniform_knots(n_ctrl, degree)
    out = np.zeros((len(params), n_ctrl))
    for i, t in enumerate(params):
        for j in range(n_ctrl):
            out[i, j] = basis_function_one(degree, kv, j, float(t))
    return out.astype(np.float32)


def uniform_knot_bspline(n_ctrl_u: int, n_ctrl_v: int, degree_u: int,
                         degree_v: int, grid_size: int = 30
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Basis matrices nu [grid, n_ctrl_u], nv [grid, n_ctrl_v] f32 on the
    parameter grid u = v = arange(0, 1, 1/grid)."""
    u = np.arange(0.0, 1.0, 1.0 / grid_size)
    return (basis_matrix_at(u, n_ctrl_u, degree_u),
            basis_matrix_at(u, n_ctrl_v, degree_v))


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


def bernstein_basis(n_ctrl: int, params: np.ndarray) -> np.ndarray:
    """Bernstein polynomial basis matrix f32 [M, n_ctrl] of degree
    n_ctrl - 1 (reference: src/approximation.py:288-309)."""
    deg = n_ctrl - 1
    t = np.asarray(params)[:, None]
    i = np.arange(n_ctrl)[None, :]
    binom = np.array([math.comb(deg, j) for j in range(n_ctrl)],
                     np.float64)[None, :]
    return (binom * (t ** i) * ((1 - t) ** (deg - i))).astype(np.float32)


def fit_surface_kronecker(nu_p: torch.Tensor, nv_p: torch.Tensor,
                          points: torch.Tensor, weights: torch.Tensor,
                          lam: float = 1e-5) -> torch.Tensor:
    """Weighted scattered-point least-squares fit of a control grid.

    nu_p [M, U] basis at each point's u-parameter, nv_p [M, V] at v,
    points [M, 3], weights [M]: min || w .* (A c - p) ||^2 with A_i =
    nu_i (x) nv_i (reference: src/approximation.py:338-364), through the
    normal equations with a ridge term lam. True f32 (the fp32 policy, no
    TF32). Returns the control grid [U, V, 3]."""
    set_fp32_policy()
    u, v = nu_p.shape[1], nv_p.shape[1]
    a = (nu_p[:, :, None] * nv_p[:, None, :]).reshape(-1, u * v)
    aw = a * weights[:, None]
    ata = aw.T @ aw
    aty = aw.T @ (points * weights[:, None])
    eye = torch.eye(u * v, dtype=ata.dtype, device=ata.device)
    return torch.linalg.solve(ata + lam * eye, aty).reshape(u, v, 3)


def regular_parameterization(grid_u: int, grid_v: int) -> np.ndarray:
    """Uniform UV grid in [0, 1]^2, f32 [grid_u * grid_v, 2]
    (reference: src/curve_utils.py:201-209)."""
    u = np.linspace(0, 1, grid_u)
    v = np.linspace(0, 1, grid_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    return np.stack([uu.reshape(-1), vv.reshape(-1)], 1).astype(np.float32)
