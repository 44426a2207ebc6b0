"""Segmentation metrics and matching over a fixed K_MAX = 50 segment axis.

Counterpart of parsenet_tpu/ops/segmentation.py (reference
src/segment_utils.py): one-hot memberships, relaxed IoU, the eval taxonomy
collapse, per-segment type votes and SIOU over LAP-matched segments.
"""
from __future__ import annotations

import torch

from .hungarian import solve_lap

K_MAX = 50  # max segments per shape (reference: src/segment_utils.py:283)


def to_one_hot(labels: torch.Tensor, k_max: int = K_MAX) -> torch.Tensor:
    """[N] int -> [N, k_max] float; labels outside [0, k_max) give a zero
    row, as jax.nn.one_hot does."""
    ar = torch.arange(k_max, device=labels.device)
    return (labels[:, None] == ar[None, :]).to(torch.float32)


def relaxed_iou(pred_one_hot: torch.Tensor,
                gt_one_hot: torch.Tensor) -> torch.Tensor:
    """Soft IoU matrix [K, K] between two [N, K] memberships."""
    dots = pred_one_hot.T @ gt_one_hot
    norms_p = torch.sum(pred_one_hot, dim=0)[:, None]
    norms_g = torch.sum(gt_one_hot, dim=0)[None, :]
    return dots / (norms_p + norms_g - dots + 1e-7)


def remap_primitive_labels(prim: torch.Tensor) -> torch.Tensor:
    """Eval taxonomy collapse {0, 6, 7} -> 9 (closed spline), 8 -> 2 (open)."""
    p = torch.where((prim == 0) | (prim == 6) | (prim == 7), 9, prim)
    return torch.where(p == 8, 2, p)


def primitive_type_per_segment(prim_one_hot: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Weighted type vote: [N, L] type scores, [N, K] memberships -> [K]."""
    votes = prim_one_hot.T @ weights
    return torch.argmax(votes, dim=0)


def siou_matched_segments(gt_labels: torch.Tensor, pred_labels: torch.Tensor,
                          pred_prim_per_point: torch.Tensor,
                          gt_prim_per_point: torch.Tensor,
                          weights: torch.Tensor, k_max: int = K_MAX,
                          min_gt_points: int = 100):
    """Segment IoU and primitive-type IoU over LAP-matched segments of one
    shape (reference src/segment_utils.py:139-242). Pairs count where the
    predicted segment is non-empty and its GT segment has >= min_gt_points
    points. weights: [N, K] memberships for the type vote.
    Returns (seg_iou, prim_iou) scalar tensors."""
    gt_prim = remap_primitive_labels(gt_prim_per_point)
    pred_prim = remap_primitive_labels(pred_prim_per_point)
    gt_oh = to_one_hot(gt_labels, k_max)
    pred_oh = to_one_hot(pred_labels, k_max)
    col_of_row = solve_lap(1.0 - relaxed_iou(pred_oh, gt_oh)).to(torch.int64)

    pred_counts = torch.sum(pred_oh, dim=0)
    gt_counts = torch.sum(gt_oh, dim=0)
    inter = pred_oh.T @ gt_oh
    r = torch.arange(k_max, device=gt_labels.device)
    c = col_of_row
    pair_inter = inter[r, c]
    iou = pair_inter / (pred_counts + gt_counts[c] - pair_inter + 1e-8)
    valid = ((pred_counts > 0) & (gt_counts[c] >= min_gt_points)).to(
        torch.float32)
    seg_iou = torch.sum(iou * valid) / (torch.sum(valid) + 1e-8)

    prim_oh = to_one_hot(pred_prim, 10)
    seg_pred_type = primitive_type_per_segment(prim_oh, weights)
    gt_votes = gt_oh.T @ to_one_hot(gt_prim, 10)
    gt_seg_type = torch.argmax(gt_votes, dim=1)
    type_match = (seg_pred_type == gt_seg_type[c]).to(torch.float32)
    prim_iou = torch.sum(type_match * valid) / (torch.sum(valid) + 1e-8)
    return seg_iou, prim_iou
