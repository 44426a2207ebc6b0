"""Serialize fitted primitive parameters + resampled surfaces.

Counterpart of parsenet_tpu/eval/save_params.py (reference
src/primitives.py:209-386, SaveParameters): store the per-segment fitted
parameters of a shape to h5 and regenerate dense surface samples / meshes
from them for visualization or downstream CAD export. The parameters come
from ops.primitive_fits (AllPrimParams, tensors), the samples from
ops.sampling; what is stored and returned is numpy.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..ops import sampling
from ..ops.primitive_fits import AllPrimParams
from ..postprocess import tessellate_grid, trim_mesh_by_distance, write_ply
from ..postprocess.meshing import remove_unreferenced

GEOM_NAMES = {0: "plane", 1: "sphere", 2: "cylinder", 3: "cone"}


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def params_to_dict(params: AllPrimParams, geom_type, valid,
                   spline_surfaces=None, spline_slots=None) -> Dict:
    """Flatten the per-segment fitted parameters into a plain dict of numpy
    arrays keyed like the reference's SaveParameters.save layout."""
    out = {
        "geom_type": _np(geom_type),
        "valid": _np(valid),
        "plane_normal": _np(params.plane.normal),
        "plane_offset": _np(params.plane.offset),
        "sphere_center": _np(params.sphere.center),
        "sphere_radius": _np(params.sphere.radius),
        "cylinder_axis": _np(params.cylinder.axis),
        "cylinder_center": _np(params.cylinder.center),
        "cylinder_radius": _np(params.cylinder.radius),
        "cone_apex": _np(params.cone.apex),
        "cone_axis": _np(params.cone.axis),
        "cone_theta": _np(params.cone.theta),
    }
    if spline_surfaces is not None:
        out["spline_surfaces"] = _np(spline_surfaces)
        out["spline_slots"] = _np(spline_slots)
    return out


def save_h5(path: str, shape_params: Dict) -> None:
    import h5py
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as hf:
        for k, v in shape_params.items():
            hf.create_dataset(k, data=v)


def load_h5(path: str) -> Dict:
    import h5py
    with h5py.File(path, "r") as hf:
        return {k: np.array(hf[k]) for k in hf.keys()}


def resample_segment_surface(shape_params: Dict, k: int,
                             seg_points: np.ndarray,
                             grid: int = 48) -> np.ndarray:
    """Dense samples [grid * grid, 3] of segment k's fitted surface, over
    its points' extent (a sphere: the whole sphere), on the CPU
    (reference: SaveParameters.load_parameters resamples for viz)."""
    t = int(shape_params["geom_type"][k])

    def par(name):
        return torch.from_numpy(np.array(shape_params[name][k:k + 1],
                                          np.float32))

    pts = torch.from_numpy(np.array(seg_points, np.float32))
    m = torch.ones((1, pts.shape[0]))
    if t == 0:
        s = sampling.sample_plane(par("plane_normal"), par("plane_offset"),
                                  pts, m, grid)
    elif t == 1:
        s = sampling.fibonacci_sphere(par("sphere_center"),
                                      par("sphere_radius"), grid)
    elif t == 2:
        s = sampling.sample_cylinder(par("cylinder_axis"),
                                     par("cylinder_center"),
                                     par("cylinder_radius"), pts, m, grid)
    elif t == 3:
        s = sampling.sample_cone(par("cone_apex"), par("cone_axis"),
                                 par("cone_theta"), pts, m, grid)
    else:
        raise ValueError(f"segment {k} is not geometric (type {t})")
    return s[0].numpy()


def export_shape_meshes(shape_params: Dict, points: np.ndarray,
                        labels: np.ndarray, out_dir: str,
                        epsilon: float = 0.05, grid: int = 48) -> List[str]:
    """Write one epsilon-trimmed PLY mesh per valid segment (reference:
    src/fitting_utils.py:713-820 visualize_bit_mapping_shape)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k in np.where(shape_params["valid"])[0]:
        seg_pts = points[labels == k]
        if len(seg_pts) < 20:
            continue
        t = int(shape_params["geom_type"][k])
        if t < 0:
            continue
        surf = resample_segment_surface(shape_params, int(k), seg_pts, grid)
        v, tris = tessellate_grid(surf, grid, grid, wrap_u=t in (2, 3))
        tris = trim_mesh_by_distance(v, tris, seg_pts, epsilon)
        if not len(tris):
            continue
        v2, tris2 = remove_unreferenced(v, tris)
        p = os.path.join(out_dir, f"segment_{k}_{GEOM_NAMES.get(t, t)}.ply")
        write_ply(p, v2, tris2)
        paths.append(p)
    return paths
