"""Auxiliary evaluation metrics.

Equivalents of reference src/eval_utils.py: SPFN-style p-coverage, split
geometric/spline residual aggregation, and label preprocessing for saved
prediction dicts. Counterpart of parsenet_tpu/eval/metrics.py: numpy
copies, but `iou_from_embeddings`, which runs the port's mean-shift and
SIOU matching.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.guards import entry_device
from ..ops.mean_shift import guard_mean_shift
from ..ops.segmentation import siou_matched_segments, to_one_hot


def p_coverage(points: np.ndarray, surface_points: np.ndarray,
               threshold: float = 0.01) -> float:
    """Fraction of input points within `threshold` of any predicted surface
    sample (reference: src/eval_utils.py:103-127)."""
    d = np.sqrt(((points[:, None] - surface_points[None]) ** 2).sum(-1).min(1))
    return float((d < threshold).mean())


def separate_losses_np(distances: Dict[int, float],
                       seg_types: Dict[int, str],
                       lamb: float = 1.0):
    """Split residuals into geometric vs spline means with the degenerate
    clamp (reference: src/eval_utils.py:130-175 / residual_utils.py:333-378)."""
    geom, spline, total = [], [], []
    for k, d in distances.items():
        if d is None:
            continue
        d = 0.1 if d > 1.0 else float(d)
        if seg_types[k] in ("open-spline", "closed-spline"):
            spline.append(d)
            total.append(d * lamb)
        else:
            geom.append(d)
            total.append(d)
    return (float(np.mean(total)) if total else 0.0,
            float(np.mean(geom)) if geom else None,
            float(np.mean(spline)) if spline else None)


def remove_unassigned(labels: np.ndarray, points: np.ndarray,
                      unassigned_value: int = 100) -> np.ndarray:
    """Assign label-`unassigned_value` points to the label of the nearest
    assigned point (reference: src/eval_utils.py:265-295)."""
    labels = labels.copy()
    bad = labels == unassigned_value
    if not bad.any() or bad.all():
        return labels
    good_idx = np.where(~bad)[0]
    d = ((points[bad][:, None] - points[good_idx][None]) ** 2).sum(-1)
    labels[bad] = labels[good_idx[np.argmin(d, axis=1)]]
    return labels


def iou_one_sample(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> float:
    """Mean per-class IoU for one shape (reference: src/eval_utils.py:8-40)."""
    eps = np.finfo(np.float32).eps
    acc = 0.0
    for c in range(num_classes):
        i = np.logical_and(pred == c, gt == c).sum() + eps
        u = np.logical_or(pred == c, gt == c).sum() + eps
        acc += i / u
    return float(acc / num_classes)


def compute_stats(shapes, max_surfaces: Optional[int] = None,
                  max_control_points: Optional[int] = None):
    """Filter ABC shapes by surface / control-point counts and strip heavy
    fields (reference: src/data_utils.py:4-46). `shapes` is a list of dicts
    with 'surfaces' entries carrying optional 'points'/'control_points'."""
    kept = []
    for sh in shapes:
        surfs = sh.get("surfaces", [])
        if max_surfaces is not None and len(surfs) > max_surfaces:
            continue
        if max_control_points is not None:
            cp_counts = [np.asarray(s.get("control_points", [])).size // 3
                         for s in surfs]
            if cp_counts and max(cp_counts) > max_control_points:
                continue
        slim = {k: v for k, v in sh.items() if k != "surfaces"}
        slim["surfaces"] = [
            {k: v for k, v in s.items() if k not in ("points", "normals")}
            for s in surfs]
        kept.append(slim)
    return kept


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def iou_from_embeddings(embedding, gt_labels, quantile: float = 0.015,
                        iterations: int = 30,
                        subset: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """Cluster an embedding [N, D] with mean-shift (guard_mean_shift, f32:
    K1 on the card, the bandwidth from a 5,000-row subset) and report the
    segment IoU over LAP-matched segments (K2) against gt_labels [N]
    (reference: src/test_utils.py:36-60 IOU_from_embeddings). The
    bandwidth subset: `subset`, else drawn from `generator`; one of them
    is needed where N > 5,000. device None = "cuda". Returns (seg_iou,
    labels [N] numpy)."""
    dev = entry_device(device)
    emb = _tensor(embedding).to(dev, torch.float32)
    if emb.shape[0] > 5000 and subset is None and generator is None:
        raise ValueError("iou_from_embeddings: pass the bandwidth subset or "
                         "a generator")
    emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-12)
    ms = guard_mean_shift(emb, quantile, iterations=iterations, subset=subset,
                          generator=generator)
    gt = _tensor(gt_labels).to(dev, torch.int64)
    dummy_prim = torch.zeros_like(gt)
    s_iou, _ = siou_matched_segments(gt, ms.labels, dummy_prim, dummy_prim,
                                     to_one_hot(ms.labels))
    return float(s_iou), ms.labels.cpu().numpy()
