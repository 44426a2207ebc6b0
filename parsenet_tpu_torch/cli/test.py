"""Fitting and reconstruction evaluation of the test split (the port's
counterpart of the root test.py).

    python -m parsenet_tpu_torch.cli.test \\
        configs/config_parsenet_normals.yml [start] [end] [--optimize] \\
        [--device cuda]

Reads {log_dir}/predictions.h5 (cli.generate_predictions), fits every
segment of shapes [start, end) of the test split with the 12 spline slots
decoded by {log_dir}/checkpoints/{open,closed}_splinenet.npz (else the
shipped params/), and reports the residual and the protocol coverage
(p_cov, sk_1, sk_2). --optimize refits every spline segment of more than
200 points on the host first (outlier removal, a 32 x 32 Kronecker
least-squares refit through the native LAP) and measures the coverage on
the refined surfaces. Where matplotlib is installed, the trimmed meshes of
the first 8 shapes are rendered to {log_dir}/reconstructions_grid.png.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import numpy as np
import torch

from .. import cpp as native
from ..core.config import load_config
from ..core.guards import entry_device
from ..core.logging import setup_logging
from ..core.profiling import StepTimer, trace
from ..eval.pipeline import (COV_SAMPLES, EVAL_SPLINE_SLOTS, SPLINE_PTS,
                             protocol_coverage, reconstruct_shape)
from ..fitting.spline_apply import trained_spline_fit
from ..ops.preprocess import BUF
from ..postprocess import optimize_spline_kronecker
from ..postprocess.meshing import (remove_unreferenced, tessellate_grid,
                                   trim_mesh_by_distance)
from ..postprocess.viz import render_reconstruction_grid
from .generate_predictions import load_test_split

log = logging.getLogger("parsenet_tpu_torch")
METRICS = ("residual", "p_cov", "sk_1", "sk_2")
RENDER_SHAPES = 8


def draw(n: int, generator: torch.Generator, eval_preprocess: bool = True):
    """One shape's draws, in reconstruct_shape's order: the coverage
    uniforms [COV_SAMPLES], then the slots' packing [12, N] and final
    draws [12, min(N, BUF)] (eval_preprocess=False: the slots'
    with-replacement draws [12, SPLINE_PTS])."""
    dev = generator.device
    uniforms = torch.rand(COV_SAMPLES, generator=generator, device=dev)
    if not eval_preprocess:
        return uniforms, torch.rand((EVAL_SPLINE_SLOTS, SPLINE_PTS),
                                    generator=generator, device=dev)
    return (uniforms,
            (torch.rand((EVAL_SPLINE_SLOTS, n), generator=generator,
                        device=dev),
             torch.rand((EVAL_SPLINE_SLOTS, min(n, BUF)),
                        generator=generator, device=dev)))


def _area_weights_np(surf: np.ndarray) -> np.ndarray:
    g = int(round(surf.shape[0] ** 0.5))
    s = surf.reshape(g, g, 3)
    tu = np.gradient(s, axis=0)
    tv = np.gradient(s, axis=1)
    return np.linalg.norm(np.cross(tu, tv), axis=-1).reshape(-1)


def refine_splines(points: np.ndarray, labels: np.ndarray,
                   prim: np.ndarray, surf: np.ndarray, weights: np.ndarray,
                   mask: np.ndarray):
    """The classical refit of test.py:60-95 on the host: each valid segment
    of more than 200 points whose voted type is a spline (open 2 or closed
    9 after the eval remap) loses its statistical outliers and has its
    surface refit on a 32 x 32 subgrid, evaluated back on the full grid,
    with fresh area weights. surf [K, g^2, 3], weights [K, g^2], mask [K]
    numpy -> (surf, weights), copies."""
    surf, weights = surf.copy(), weights.copy()
    prim_remap = prim.copy()
    for v in (0, 6, 7):
        prim_remap[prim_remap == v] = 9
    prim_remap[prim_remap == 8] = 2
    g = int(round(surf.shape[1] ** 0.5))
    for k in np.flatnonzero(mask):
        seg_pts = points[labels == k]
        # splines need >= 100 points, the classical refit runs above 200
        # (reference primitive_forward.py:978-996)
        if len(seg_pts) <= 200:
            continue
        seg_prim = np.bincount(prim_remap[labels == k], minlength=10).argmax()
        if seg_prim not in (2, 9):
            continue
        seg_pts = native.remove_outliers(seg_pts.astype(np.float32))
        sub32 = surf[k].reshape(g, g, 3)[::g // 32, ::g // 32]
        surf[k] = optimize_spline_kronecker(
            sub32.reshape(-1, 3), seg_pts, closed=bool(seg_prim == 9),
            grid_u=32, grid_v=32, eval_grid=(g, g))
        weights[k] = _area_weights_np(surf[k])
    return surf, weights


def trimmed_segment_meshes(surf: np.ndarray, mask: np.ndarray,
                           points: np.ndarray, labels: np.ndarray,
                           epsilon: float = 0.1):
    """Per-segment eps-trimmed surface meshes for rendering (the reference
    trims triangles farther than eps from the input, fitting_utils.py:
    646-691): [(vertices, triangles, segment id)]."""
    segs = []
    g = int(round(surf.shape[1] ** 0.5))
    for k in np.flatnonzero(mask):
        seg_pts = points[labels == k]
        if len(seg_pts) < 20:
            continue
        v, t = tessellate_grid(surf[k], g, g)
        t = trim_mesh_by_distance(v, t, seg_pts, epsilon)
        if len(t) == 0:
            continue
        v, t = remove_unreferenced(v, t)
        segs.append((v, t, int(k)))
    return segs


@torch.no_grad()
def evaluate_split(points, normals, seg_ids, pred_prims, spline_fit,
                   generator: Optional[torch.Generator] = None, draws=None,
                   if_optimize: bool = False, render_shapes: int = 0,
                   eval_preprocess: bool = True, device=None,
                   timer: Optional[StepTimer] = None) -> dict:
    """Fit and measure S shapes: points / normals [S, N, 3], seg_ids /
    pred_prims [S, N] (predictions.h5), spline_fit (None: the spline-free
    arm). Each shape's draws are draws[i] = (uniforms, slot_uniforms), else
    made by `draw` from `generator`; with if_optimize the refined surfaces'
    coverage takes the same uniforms, as test.py's does. eval_preprocess
    False samples the spline segments without the outlier removal and
    upsampling (reconstruct_shape's). Returns per-shape
    lists of METRICS (the refined coverage where if_optimize) and, for the
    first render_shapes shapes, their trimmed meshes ("meshes")."""
    dev = entry_device(device)
    out = {k: [] for k in METRICS}
    out["meshes"] = []
    for i in range(len(points)):
        uniforms, slot_uniforms = (draws[i] if draws is not None
                                   else draw(points[i].shape[0], generator,
                                             eval_preprocess))
        if timer is not None:
            timer.start()
        with trace("reconstruct_shape"):
            rec = reconstruct_shape(points[i], normals[i], seg_ids[i],
                                    pred_prims[i], uniforms=uniforms,
                                    spline_fit=spline_fit,
                                    slot_uniforms=slot_uniforms,
                                    eval_preprocess=eval_preprocess,
                                    device=dev)
        m = {k: float(getattr(rec, k)) for k in METRICS}
        surf = rec.surface_points.cpu().numpy()
        mask = rec.surface_mask.cpu().numpy().astype(bool)
        if if_optimize:
            with trace("refine_splines"):
                surf, w = refine_splines(
                    np.asarray(points[i], np.float32),
                    np.asarray(seg_ids[i]), np.asarray(pred_prims[i]), surf,
                    rec.area_weights.cpu().numpy(), mask)
                fw = (mask[:, None] * w).reshape(-1).astype(np.float32)
                cov = protocol_coverage(
                    torch.from_numpy(np.asarray(points[i], np.float32)
                                     ).to(dev),
                    torch.from_numpy(surf.reshape(-1, 3)).to(dev),
                    torch.from_numpy(fw).to(dev),
                    torch.as_tensor(uniforms, device=dev))
            m.update(zip(("p_cov", "sk_1", "sk_2"), map(float, cov)))
        if timer is not None:
            timer.stop(dev)
        for k in METRICS:
            out[k].append(m[k])
        log.info("shape %d residual %.4f cov %.4f sk1 %.3f sk2 %.3f", i,
                 m["residual"], m["p_cov"], m["sk_1"], m["sk_2"])
        if i < render_shapes:
            out["meshes"].append(trimmed_segment_meshes(
                surf, mask, np.asarray(points[i]), np.asarray(seg_ids[i])))
    return out


def can_render() -> bool:
    """Whether matplotlib, which postprocess.viz renders with, is
    installed (without it the meshes are not built)."""
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def read_predictions(path: str):
    import h5py
    with h5py.File(path, "r") as hf:
        return np.array(hf.get("seg_id")), np.array(hf.get("pred_primitives"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Fit and measure the test split's predictions.")
    ap.add_argument("config", nargs="?", default=None,
                    help="configs/config_parsenet*.yml")
    ap.add_argument("start", nargs="?", type=int, default=0)
    ap.add_argument("end", nargs="?", type=int, default=None)
    ap.add_argument("--optimize", action="store_true",
                    help="refit the spline segments before the coverage")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    dev = entry_device(args.device)
    setup_logging(cfg.log_dir, "test")
    points, _, normals, _ = load_test_split(cfg)   # the first num_test
    seg_ids, pred_prims = read_predictions(
        os.path.join(cfg.log_dir, "predictions.h5"))
    start = args.start
    end = len(points) if args.end is None else min(args.end, len(points))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    timer = StepTimer(skip_first=1)
    out = evaluate_split(points[start:end], normals[start:end],
                         seg_ids[start:end], pred_prims[start:end],
                         trained_spline_fit(cfg.log_dir, cfg.grid_size, dev),
                         generator=gen, if_optimize=args.optimize,
                         render_shapes=RENDER_SHAPES if can_render() else 0,
                         device=dev, timer=timer)
    log.info("MEAN residual %.4f chamfer-cov %.4f sk1 %.3f sk2 %.3f; %.2f "
             "ms a shape", *(np.mean(out[k]) for k in METRICS),
             1000.0 * timer.summary()["mean_s"])
    path = os.path.join(cfg.log_dir, "reconstructions_grid.png")
    if out["meshes"] and render_reconstruction_grid(path, out["meshes"]):
        log.info("wrote %s", path)
    return out


if __name__ == "__main__":
    main()
