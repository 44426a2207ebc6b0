"""Visualization utilities (host-side, renderer-free).

Equivalents of the reference's src/VisUtils.py + src/color_utils.py without
the Open3D render windows (headless): pastel color
generation, colored segment point clouds, grids of shapes laid out in a
plane, and matplotlib scatter snapshots — all exportable as PLY/PNG. A
numpy copy of parsenet_tpu/postprocess/viz.py: without matplotlib the
render_* functions return False and write nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .meshing import write_ply


def random_pastel_colors(n: int, seed: int = 3) -> np.ndarray:
    """[n, 3] float colors in [0.4, 0.95] (reference: color_utils.py)."""
    rng = np.random.RandomState(seed)
    return 0.4 + 0.55 * rng.rand(n, 3)


def colored_segmentation(points: np.ndarray, labels: np.ndarray,
                         k_max: int = 50) -> np.ndarray:
    """Per-point colors by segment id."""
    palette = random_pastel_colors(k_max)
    return palette[np.clip(labels, 0, k_max - 1)]


def save_segmentation_ply(path: str, points: np.ndarray,
                          labels: np.ndarray) -> None:
    write_ply(path, points, colors=colored_segmentation(points, labels))


def grid_of_shapes(shapes: Sequence[np.ndarray], cols: int = 5,
                   spacing: float = 2.5) -> np.ndarray:
    """Lay out multiple point clouds on a plane grid (reference:
    VisUtils grid renders). Returns concatenated points."""
    out = []
    for i, s in enumerate(shapes):
        r, c = divmod(i, cols)
        offset = np.array([c * spacing, -r * spacing, 0.0], np.float32)
        out.append(np.asarray(s, np.float32) + offset)
    return np.concatenate(out, 0)


def save_xyz(path: str, points: np.ndarray,
             normals: Optional[np.ndarray] = None) -> None:
    """Plain .xyz export (reference: VisUtils.py:177-199)."""
    arr = points if normals is None else np.concatenate([points, normals], 1)
    np.savetxt(path, arr, fmt="%.6f")


def scatter_png(path: str, points: np.ndarray,
                colors: Optional[np.ndarray] = None, size: float = 1.0) -> None:
    """Matplotlib 3D scatter snapshot (best-effort; headless-safe)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=colors, s=size)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


# --------------------------------------------------------------------------
# Offline mesh rendering — headless equivalents of the reference's Open3D
# screenshot pipelines (src/VisUtils.py:246-400): same fixed camera pose
# (euler -15deg, -35deg, 35rad), rendered with matplotlib Poly3DCollection.
# --------------------------------------------------------------------------

def _view_matrix() -> np.ndarray:
    """The reference's screenshot rotation (VisUtils.py:247-248,265-266)."""
    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    # transforms3d.euler2mat default 'sxyz' convention
    return (rz(35.0) @ ry(-35 * np.pi / 180) @ rx(-15 * np.pi / 180)
            ).astype(np.float32)


def _add_mesh(ax, vertices: np.ndarray, triangles: np.ndarray,
              color, rot: np.ndarray) -> None:
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    v = np.asarray(vertices, np.float32) @ rot.T
    tris = v[np.asarray(triangles, np.int64)]
    # simple Lambertian shading from the face normals
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= (np.linalg.norm(n, axis=1, keepdims=True) + 1e-9)
    lam = 0.45 + 0.55 * np.abs(n @ np.array([0.3, 0.4, 0.86]))
    base = np.asarray(color, np.float32).reshape(1, 3)
    face_colors = np.clip(base * lam[:, None], 0, 1)
    pc = Poly3DCollection(tris, linewidths=0)
    pc.set_facecolor(face_colors)
    ax.add_collection3d(pc)
    return v


def render_meshes_png(path: str, meshes, figsize: float = 6.0,
                      dpi: int = 120) -> bool:
    """Render a list of (vertices, triangles, rgb_color) meshes from the
    reference's fixed screenshot camera into a PNG. Headless equivalent of
    VisUtils.custom_draw_geometry_load_option /
    save_images_from_list_pcds_meshes (src/VisUtils.py:246-310).
    Returns True when an image was written."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    rot = _view_matrix()
    fig = plt.figure(figsize=(figsize, figsize))
    ax = fig.add_subplot(111, projection="3d")
    allv = []
    for vertices, triangles, color in meshes:
        if len(triangles) == 0:
            continue
        allv.append(_add_mesh(ax, vertices, triangles, color, rot))
    if allv:
        v = np.concatenate(allv)
        lo, hi = v.min(0), v.max(0)
        c, r = (lo + hi) / 2, float((hi - lo).max()) / 2 + 1e-6
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[1] - r, c[1] + r)
        ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return True


def render_reconstruction_grid(path: str, shapes, cols: int = 4,
                               spacing: float = 2.5, k_max: int = 50) -> bool:
    """Grid-of-reconstructions render: `shapes` is a list of per-shape lists
    of (vertices, triangles, segment_id). Segments are colored by id with
    the shared pastel palette; shapes are laid out on a plane grid like the
    reference's grid_meshes_lists_visulation (src/VisUtils.py:504-535)."""
    palette = random_pastel_colors(k_max)
    meshes = []
    for i, segs in enumerate(shapes):
        r, c = divmod(i, cols)
        off = np.array([c * spacing, -r * spacing, 0.0], np.float32)
        for vertices, triangles, seg_id in segs:
            meshes.append((np.asarray(vertices, np.float32) + off, triangles,
                           palette[int(seg_id) % k_max]))
    return render_meshes_png(path, meshes,
                             figsize=max(6.0, 2.5 * cols))
