"""ABC feature-file surface sampling (numpy-only, no geomdl).

Equivalent of reference src/curve_utils.py:43-200 (DrawSurfs): sample points
on the parametric surfaces described by ABC feature dicts — plane, cylinder,
sphere, cone, torus — and on B-spline / rational NURBS patches with
arbitrary knot vectors (multiplicities included). The reference evaluates
splines through geomdl; here the basis functions come from
ops.bspline.basis_function_one (NURBS Book Alg 2.4), so the module has no
dependency beyond numpy.

Feature dicts accept both the raw ABC schema keys (x_axis/y_axis/z_axis,
vert_parameters) and a simplified form (a single `axis` from which an
orthonormal frame is derived; default parameter ranges). A numpy copy of
parsenet_tpu/data/features.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.bspline import basis_function_one


def _unit(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / (np.linalg.norm(v) + 1e-12)


def _frame(feat: dict):
    """Orthonormal (x, y, z) frame: use the ABC x/y/z axes when present,
    else derive one from `axis` (taken as z)."""
    if "x_axis" in feat and "y_axis" in feat:
        x = _unit(feat["x_axis"])
        y = _unit(feat["y_axis"])
        z = _unit(feat.get("z_axis", np.cross(x, y)))
        return x, y, z
    z = _unit(feat.get("axis", (0.0, 0.0, 1.0)))
    ref = np.array([1.0, 0.0, 0.0])
    if abs(z @ ref) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    x = _unit(np.cross(ref, z))
    y = np.cross(z, x)
    return x, y, z


def _param_range(feat: dict, default_u, default_v):
    """(u_min, u_max, v_min, v_max) from vert_parameters when present
    (reference: curve_utils.py:47-50), else the given defaults."""
    if "vert_parameters" in feat and len(feat["vert_parameters"]):
        p = np.asarray(feat["vert_parameters"], np.float64)
        return p[:, 0].min(), p[:, 0].max(), p[:, 1].min(), p[:, 1].max()
    return default_u[0], default_u[1], default_v[0], default_v[1]


def _grid(u0, u1, v0, v1, g):
    u = np.linspace(u0, u1, g)
    v = np.linspace(v0, v1, g)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    return uu.reshape(-1, 1), vv.reshape(-1, 1)


def sample_feature(feat: dict, grid: int = 20) -> Optional[np.ndarray]:
    """Sample a [grid*grid, 3] point grid on the feature surface.

    Supported types (case-insensitive): plane, cylinder, sphere, cone,
    torus, bspline. Returns None for unsupported types (the reference's
    function_dict would KeyError; callers skip those surfaces).
    """
    t = str(feat.get("type", "")).lower()
    l = np.asarray(feat.get("location", (0.0, 0.0, 0.0)), np.float64)

    if t == "plane":
        x, y, _ = _frame(feat)
        u0, u1, v0, v1 = _param_range(feat, (-1, 1), (-1, 1))
        u, v = _grid(u0, u1, v0, v1, grid)
        pts = l + u * x[None] + v * y[None]
    elif t == "cylinder":
        x, y, z = _frame(feat)
        r = float(feat["radius"])
        _, _, v0, v1 = _param_range(feat, (0, 2 * np.pi), (-1, 1))
        u, v = _grid(0, 2 * np.pi, v0, v1, grid)
        pts = l + np.cos(u) * r * x + np.sin(u) * r * y + v * z
    elif t == "sphere":
        x, y, z = _frame(feat)
        r = float(feat["radius"])
        u0, u1, v0, v1 = _param_range(feat, (0, 2 * np.pi),
                                      (-np.pi / 2, np.pi / 2))
        u, v = _grid(u0, u1, v0, v1, grid)
        pts = (l + r * np.cos(v) * (np.cos(u) * x + np.sin(u) * y)
               + r * np.sin(v) * z)
    elif t == "cone":
        x, y, z = _frame(feat)
        r = float(feat["radius"])
        a = float(feat["angle"])
        _, _, v0, v1 = _param_range(feat, (0, 2 * np.pi), (0, 1))
        u, v = _grid(0, 2 * np.pi, v0, v1, grid)
        pts = (l + (r + v * np.sin(a)) * (np.cos(u) * x + np.sin(u) * y)
               + v * np.cos(a) * z)
    elif t == "torus":
        x, y, z = _frame(feat)
        r_max = float(feat["max_radius"])
        r_min = float(feat["min_radius"])
        u, v = _grid(0, 2 * np.pi, 0, 2 * np.pi, grid)
        pts = (l + (r_max + r_min * np.cos(v)) * (np.cos(u) * x
                                                  + np.sin(u) * y)
               + r_min * np.sin(v) * z)
    elif t in ("bspline", "nurbs"):
        return sample_spline_patch(feat, grid)
    else:
        return None
    return np.ascontiguousarray(pts, np.float32)


def _basis_matrix(params: np.ndarray, knots, degree: int,
                  n_ctrl: int) -> np.ndarray:
    kv = np.asarray(knots, np.float64)
    out = np.zeros((len(params), n_ctrl))
    for i, t in enumerate(params):
        for j in range(n_ctrl):
            out[i, j] = basis_function_one(degree, kv, j, float(t))
    return out


def sample_spline_patch(feat: dict, grid: int = 20) -> np.ndarray:
    """Evaluate a B-spline / NURBS patch from an ABC feature dict
    (reference: curve_utils.py:133-181 via geomdl). Keys: control_points (or
    `poles`) [U, V, 3], u_knots, v_knots (with multiplicities), u_degree,
    v_degree, optional weights [U, V] (rational)."""
    cps = np.asarray(feat.get("control_points", feat.get("poles")),
                     np.float64)
    du, dv = int(feat["u_degree"]), int(feat["v_degree"])
    ku = np.asarray(feat["u_knots"], np.float64)
    kv = np.asarray(feat["v_knots"], np.float64)
    U, V = cps.shape[0], cps.shape[1]
    # valid parameter range excludes the clamped ends' exterior
    u0, u1 = ku[du], ku[-du - 1]
    v0, v1 = kv[dv], kv[-dv - 1]
    eps = 1e-9  # basis_function_one is right-open at the domain end
    us = np.linspace(u0, u1 - eps * (u1 - u0), grid)
    vs = np.linspace(v0, v1 - eps * (v1 - v0), grid)
    nu = _basis_matrix(us, ku, du, U)     # [g, U]
    nv = _basis_matrix(vs, kv, dv, V)     # [g, V]
    w = feat.get("weights")
    if w is not None and not feat.get("u_rational", True) is False:
        w = np.asarray(w, np.float64).reshape(U, V)
        hom = np.concatenate([cps * w[..., None], w[..., None]], -1)  # [U,V,4]
        s = np.einsum("gu,uvc,hv->ghc", nu, hom, nv)
        pts = s[..., :3] / (s[..., 3:4] + 1e-12)
    else:
        pts = np.einsum("gu,uvc,hv->ghc", nu, cps, nv)
    return np.ascontiguousarray(pts.reshape(grid * grid, 3), np.float32)
