"""Mesh construction, trimming and I/O (host-side, dependency-free).

Equivalents of the reference's Open3D/geomdl mesh path:
* `tessellate_grid` — triangulate a regular surface-sample grid
  (reference: src/fitting_utils.py:276-303 tessalate_points_fast,
  src/VisUtils.py:163-174).
* `trim_mesh_by_distance` — drop triangles farther than epsilon from the
  input points ("bit mapping", reference: src/fitting_utils.py:646-691),
  which turns the infinite/extended primitive surfaces into trimmed patches.
* `write_ply` / `read_ply` — ASCII PLY I/O replacing Open3D file I/O.

A numpy copy of parsenet_tpu/postprocess/meshing.py.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def tessellate_grid(points: np.ndarray, size_u: int, size_v: int,
                    wrap_u: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulate grid samples [size_u * size_v, 3] -> (vertices, triangles).

    wrap_u connects the last row back to the first (closed splines,
    cylinders, cones sampled over the angle axis).
    """
    verts = np.asarray(points, np.float32).reshape(size_u * size_v, 3)
    tris = []
    ui_max = size_u if wrap_u else size_u - 1
    for i in range(ui_max):
        i2 = (i + 1) % size_u
        for j in range(size_v - 1):
            a = i * size_v + j
            b = i2 * size_v + j
            c = i2 * size_v + j + 1
            d = i * size_v + j + 1
            tris.append([a, b, c])
            tris.append([a, c, d])
    return verts, np.asarray(tris, np.int32)


def trim_mesh_by_distance(vertices: np.ndarray, triangles: np.ndarray,
                          points: np.ndarray, epsilon: float,
                          chunk: int = 4096) -> np.ndarray:
    """Keep triangles whose centroid lies within epsilon of any input point
    (reference: src/fitting_utils.py:646-691 bit_mapping_points)."""
    cent = vertices[triangles].mean(1)  # [T, 3]
    keep = np.zeros(len(cent), bool)
    pts = np.asarray(points, np.float32)
    for s in range(0, len(cent), chunk):
        d = ((cent[s:s + chunk, None] - pts[None]) ** 2).sum(-1).min(1)
        keep[s:s + chunk] = d < epsilon * epsilon
    return triangles[keep]


def remove_unreferenced(vertices: np.ndarray, triangles: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    used = np.unique(triangles)
    remap = -np.ones(len(vertices), np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[triangles].astype(np.int32)


def write_ply(path: str, vertices: np.ndarray,
              triangles: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY writer (points or mesh)."""
    v = np.asarray(vertices, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(v)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if triangles is not None:
            f.write(f"element face {len(triangles)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if colors is not None:
            c = np.asarray(colors)
            if c.dtype != np.uint8:
                c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
            for p, cc in zip(v, c):
                f.write(f"{p[0]} {p[1]} {p[2]} {cc[0]} {cc[1]} {cc[2]}\n")
        else:
            for p in v:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        if triangles is not None:
            for t in np.asarray(triangles, np.int64):
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Minimal ASCII PLY reader for files written by write_ply."""
    with open(path) as f:
        assert f.readline().strip() == "ply"
        n_vert = n_face = 0
        props = 0
        line = f.readline()
        while line.strip() != "end_header":
            t = line.split()
            if t[:2] == ["element", "vertex"]:
                n_vert = int(t[2])
            elif t[:2] == ["element", "face"]:
                n_face = int(t[2])
            elif t[0] == "property" and t[1] != "list":
                props += 1
            line = f.readline()
        verts = np.array([f.readline().split()[:3] for _ in range(n_vert)],
                         np.float32)
        tris = None
        if n_face:
            tris = np.array([f.readline().split()[1:4] for _ in range(n_face)],
                            np.int32)
    return verts, tris


def sample_mesh(vertices: np.ndarray, triangles: np.ndarray, n: int,
                seed: int = 0) -> np.ndarray:
    """Area-weighted barycentric sampling (reference: src/utils.py:85-171
    sample_mesh / segment_utils.py:83-123 sample_from_collection_of_mesh)."""
    rng = np.random.RandomState(seed)
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = area / (area.sum() + 1e-12)
    tri = rng.choice(len(triangles), n, p=p)
    r1 = np.sqrt(rng.rand(n, 1)).astype(np.float32)
    r2 = rng.rand(n, 1).astype(np.float32)
    return ((1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri]
            + r1 * r2 * v2[tri]).astype(np.float32)
