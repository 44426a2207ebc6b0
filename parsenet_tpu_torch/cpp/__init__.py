"""ctypes binding of the native host components: the dense LAP (LAPJV),
statistical outlier removal and ARAP deformation.

Counterpart of parsenet_tpu/cpp/__init__.py, with the port's own copies of
the C++ sources (lap.cpp, outlier.cpp, arap.cpp, beside this file). The
library is built with g++ on first use into parsenet_tpu_torch/csrc/build/,
named by a digest of the sources and the flags. A failed build or load
raises: there is no Python or scipy substitute and no switch that turns
the library off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = tuple(HERE / s for s in ("lap.cpp", "outlier.cpp", "arap.cpp"))
BUILD_DIR = HERE.parent / "csrc" / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
_lib = None


def lib_path() -> Path:
    """The library's path: csrc/build/libparsenet_native_<digest>.so."""
    digest = hashlib.sha1(b"".join(s.read_bytes() for s in SOURCES)
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libparsenet_native_{digest}.so"


def build_command(out: Path) -> list:
    return ["g++", *CXX_FLAGS, "-o", str(out), *map(str, SOURCES)]


_F64, _F32, _I32, _U8 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
                         for t in (np.float64, np.float32, np.int32,
                                   np.uint8))


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first where it does not exist yet."""
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(build_command(tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("native: g++ failed\n" + proc.stdout
                               + proc.stderr)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.lapjv.restype = ctypes.c_double
    lib.lapjv.argtypes = [_F64, ctypes.c_int32, _I32, _I32]
    lib.remove_statistical_outliers.restype = ctypes.c_int32
    lib.remove_statistical_outliers.argtypes = [
        _F32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float, _U8]
    lib.arap_deform.restype = None
    lib.arap_deform.argtypes = [_F32, ctypes.c_int32, _I32, ctypes.c_int32,
                                _I32, _F32, ctypes.c_int32, ctypes.c_int32]
    _lib = lib
    return _lib


def solve_dense(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact LAP of a square cost matrix; (rids, cids) as
    lapsolver.solve_dense returns them."""
    cost = np.ascontiguousarray(cost, np.float64)
    n = cost.shape[0]
    col_of_row = np.empty(n, np.int32)
    row_of_col = np.empty(n, np.int32)
    get_lib().lapjv(cost, n, col_of_row, row_of_col)
    return np.arange(n, dtype=np.int32), col_of_row


def remove_outliers(points: np.ndarray, nb_neighbors: int = 20,
                    std_ratio: float = 2.0) -> np.ndarray:
    """Statistical outlier removal (the reference's fitting_utils.
    remove_outliers): the points whose mean distance to their
    nb_neighbors nearest lies within std_ratio deviations of the mean."""
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]
    mask = np.empty(n, np.uint8)
    get_lib().remove_statistical_outliers(pts, n, nb_neighbors, std_ratio,
                                          mask)
    return pts[mask.astype(bool)]


def arap_deform(vertices: np.ndarray, triangles: np.ndarray,
                handle_idx: np.ndarray, handle_pos: np.ndarray,
                max_iter: int = 50) -> np.ndarray:
    """As-rigid-as-possible deformation of a triangle mesh with the handle
    vertices moved to handle_pos (Open3D's deform_as_rigid_as_possible,
    reference fitting_optimization.py:71-72). Returns the vertices."""
    v = np.ascontiguousarray(vertices, np.float32).copy()
    t = np.ascontiguousarray(triangles, np.int32)
    hi = np.ascontiguousarray(handle_idx, np.int32)
    hp = np.ascontiguousarray(handle_pos, np.float32)
    get_lib().arap_deform(v, v.shape[0], t, t.shape[0], hi, hp, hi.shape[0],
                          max_iter)
    return v
