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
    """[..., N] int -> [..., N, k_max] float; labels outside [0, k_max) give
    a zero row, as jax.nn.one_hot does."""
    ar = torch.arange(k_max, device=labels.device)
    return (labels[..., None] == ar).to(torch.float32)


def relaxed_iou(pred_one_hot: torch.Tensor,
                gt_one_hot: torch.Tensor) -> torch.Tensor:
    """Soft IoU matrix [..., K, K] between two [..., N, K] memberships."""
    dots = pred_one_hot.transpose(-1, -2) @ gt_one_hot
    norms_p = torch.sum(pred_one_hot, dim=-2)[..., :, None]
    norms_g = torch.sum(gt_one_hot, dim=-2)[..., None, :]
    return dots / (norms_p + norms_g - dots + 1e-7)


def remap_primitive_labels(prim: torch.Tensor) -> torch.Tensor:
    """Eval taxonomy collapse {0, 6, 7} -> 9 (closed spline), 8 -> 2 (open)."""
    p = torch.where((prim == 0) | (prim == 6) | (prim == 7), 9, prim)
    return torch.where(p == 8, 2, p)


def primitive_type_per_segment(prim_one_hot: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Weighted type vote: [..., N, L] type scores, [..., N, K] memberships
    -> [..., K]."""
    votes = prim_one_hot.transpose(-1, -2) @ weights
    return torch.argmax(votes, dim=-2)


def siou_matched_segments(gt_labels: torch.Tensor, pred_labels: torch.Tensor,
                          pred_prim_per_point: torch.Tensor,
                          gt_prim_per_point: torch.Tensor,
                          weights: torch.Tensor, k_max: int = K_MAX,
                          min_gt_points: int = 100):
    """Segment IoU and primitive-type IoU over LAP-matched segments
    (reference src/segment_utils.py:139-242), of one shape ([N] labels,
    weights [N, K]) or of a batch ([B, N], [B, N, K]). Pairs count where
    the predicted segment is non-empty and its GT segment has >=
    min_gt_points points. weights: memberships for the type vote. A batch
    is one solve_lap of B matrices (one K2 launch on the card); each shape's
    result is the one-shape call's. Returns (seg_iou, prim_iou): scalar
    tensors, or [B] each."""
    one = gt_labels.dim() == 1
    if one:
        gt_labels, pred_labels, pred_prim_per_point, gt_prim_per_point, \
            weights = (t[None] for t in (gt_labels, pred_labels,
                                         pred_prim_per_point,
                                         gt_prim_per_point, weights))
    gt_prim = remap_primitive_labels(gt_prim_per_point)
    pred_prim = remap_primitive_labels(pred_prim_per_point)
    gt_oh = to_one_hot(gt_labels, k_max)                   # [B, N, K]
    pred_oh = to_one_hot(pred_labels, k_max)
    col_of_row = solve_lap(1.0 - relaxed_iou(pred_oh, gt_oh)).to(torch.int64)

    pred_counts = torch.sum(pred_oh, dim=1)                # [B, K]
    gt_counts = torch.sum(gt_oh, dim=1)
    inter = pred_oh.transpose(1, 2) @ gt_oh                # [B, K, K]
    c = col_of_row
    pair_inter = torch.gather(inter, 2, c[..., None])[..., 0]
    gt_c = torch.gather(gt_counts, 1, c)
    iou = pair_inter / (pred_counts + gt_c - pair_inter + 1e-8)
    valid = ((pred_counts > 0) & (gt_c >= min_gt_points)).to(torch.float32)
    n_valid = torch.sum(valid, dim=1) + 1e-8
    seg_iou = torch.sum(iou * valid, dim=1) / n_valid

    prim_oh = to_one_hot(pred_prim, 10)
    seg_pred_type = primitive_type_per_segment(prim_oh, weights)
    gt_votes = gt_oh.transpose(1, 2) @ to_one_hot(gt_prim, 10)
    gt_seg_type = torch.argmax(gt_votes, dim=2)
    type_match = (seg_pred_type == torch.gather(gt_seg_type, 1, c)).to(
        torch.float32)
    prim_iou = torch.sum(type_match * valid, dim=1) / n_valid
    return (seg_iou[0], prim_iou[0]) if one else (seg_iou, prim_iou)


def mean_iou_per_class(gt: torch.Tensor, pred_logits: torch.Tensor,
                       num_classes: int = 10) -> torch.Tensor:
    """Per-class IoU of the argmax type against gt, averaged over classes
    and shapes (reference src/segment_loss.py:127-148, evaluate_miou); a
    class absent from both counts as IoU 1. gt [B, N] int, pred_logits
    [B, N, C] -> scalar."""
    pred = torch.argmax(pred_logits, dim=-1)
    eps = float(torch.finfo(torch.float32).eps)
    cls = torch.arange(num_classes, device=gt.device)[:, None, None]
    g, p = gt[None] == cls, pred[None] == cls                  # [C, B, N]
    inter = torch.sum(g & p, dim=-1).to(torch.float32) + eps
    union = torch.sum(g | p, dim=-1).to(torch.float32) + eps
    iou = inter / union
    return torch.sum(iou) * (1.0 / iou.numel())   # XLA's mean: sum x 1/n
