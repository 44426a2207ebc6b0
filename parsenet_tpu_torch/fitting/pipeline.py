"""The train-time fitting loss of one shape, differentiable.

Counterpart of parsenet_tpu/fitting/pipeline.py (reference
src/residual_utils.py:86-208, src/primitive_forward.py:925-1047): the
reference's per-segment loop as fixed shapes over K_MAX = 50 clusters.

* mean-shift (`guard_mean_shift(differentiable=True)`: escalation attempts
  on K1 f32, the accepted bandwidth re-run with autograd) -> cluster
  centres -> soft membership weights [K_MAX, N];
* Hungarian matching of clusters to GT segments (`solve_lap`, K2);
* each cluster's GT primitive type by a one-hot vote;
* all four geometric fits to every cluster on the stride-4 subsample,
  residuals on the matched GT segment's points;
* up to SPLINE_SLOTS spline segments through the frozen SplineNets
  (`SplineFit.batched`) on the strided cloud with soft weights, their
  surfaces held to the GT segment by a two-sided chamfer, the 4 slots in
  one `min_sqdist` call each way (K3 forward, K4 backward);
* separate_losses: a residual > 1 counts as 0.1, spline residuals are
  scaled by lamb, the mean runs over valid segments
  (reference residual_utils.py:333-378).

`ablate` (ABLATE_ARMS) stubs stages for in-context stage costing by
cli.bench_train, as the JAX package's arms do; no production path sets it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.guards import EPS, guard_exp
from ..core.profiling import StageTimer, trace
from ..ops.chamfer import min_sqdist
from ..ops.hungarian import solve_lap
from ..ops.mean_shift import MeanShiftResult, guard_mean_shift
from ..ops.primitive_dist import geom_type_from_label, residual_select
from ..ops.primitive_fits import fit_all_primitives_shared_points
from ..ops.segmentation import (K_MAX, relaxed_iou, siou_matched_segments,
                                to_one_hot)

SPLINE_SLOTS = 4  # the reference trains at most 4 spline fits a shape
SPLINE_LABELS_OPEN = (2, 8)
SPLINE_LABELS_CLOSED = (0, 6, 7, 9)
STAGES = ("mean_shift", "matching", "fits", "spline", "chamfer")
# ms: GT-segment clusters instead of mean-shift and matching; match:
# identity columns instead of the LAP; fits: zero geometric residuals;
# siou: no SIOU metric (0)
ABLATE_ARMS = ("ms", "match", "fits", "siou")
_NO_TIMER = StageTimer(False)


class FittingLossOut(NamedTuple):
    loss: torch.Tensor          # scalar residual loss
    geom_loss: torch.Tensor     # mean residual over geometric segments
    spline_loss: torch.Tensor   # mean residual over spline segments
    seg_iou: torch.Tensor
    prim_iou: torch.Tensor
    num_clusters: int


def weights_normalize(weights: torch.Tensor, bw: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Mean-shift-kernel softmax over clusters, then each cluster row
    rescaled to [0, 1] (reference src/fitting_utils.py:306-325).
    weights [K, N] dot products, valid [K] row mask. amin / amax split
    their gradient among equal entries, as the JAX package's min and max
    do."""
    z = weights / (bw ** 2) / 2.0
    z = torch.where(valid[:, None], z, float("-inf"))
    prob = guard_exp(z)
    prob = prob / (torch.sum(prob, dim=0, keepdim=True) + EPS)
    prob = prob - torch.amin(prob, dim=1, keepdim=True)
    prob = prob / (torch.amax(prob, dim=1, keepdim=True) + EPS)
    return torch.where(valid[:, None], prob, 0.0)


def cluster_centers(ms: MeanShiftResult, embedding: torch.Tensor):
    """([K_MAX, D] centres in point-index order, zero past the clusters,
    [K_MAX] validity), like the reference's new_X[unique centers]."""
    order = torch.argsort(1.0 - ms.center_mask, stable=True)
    valid = torch.arange(K_MAX, device=embedding.device) < ms.num_clusters
    centers = ms.shifted[order[:K_MAX]]
    return torch.where(valid[:, None], centers, 0.0), valid


def gt_segment_prim_votes(gt_labels: torch.Tensor,
                          gt_prim: torch.Tensor) -> torch.Tensor:
    """[K_MAX, 10] type votes of each GT segment (scipy.stats.mode's
    counterpart, reference residual_utils.py:187)."""
    return to_one_hot(gt_labels).T @ to_one_hot(gt_prim, 10)


def _isin(t: torch.Tensor, values) -> torch.Tensor:
    with trace("sync.isin_values"):   # values copied to the card
        v = torch.tensor(values, device=t.device)
    return torch.isin(t, v)


def fitting_loss_shape(points: torch.Tensor, normals: torch.Tensor,
                       embedding: torch.Tensor, gt_labels: torch.Tensor,
                       gt_prim: torch.Tensor,
                       subset: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       pred_prim_per_point: Optional[torch.Tensor] = None,
                       spline_fit=None, quantile: float = 0.025,
                       iterations: int = 5, lamb: float = 1.0,
                       ms_num_samples: int = 5000, spline_stride: int = 2,
                       residual_stride: int = 1, siou_stride: int = 1,
                       ms_attempt_iterations: Optional[int] = None,
                       ablate=(),
                       timer: StageTimer = _NO_TIMER) -> FittingLossOut:
    """Train-time residual loss of ONE shape.

    points / normals [N, 3]; embedding [N, D] raw (normalised here);
    gt_labels [N] int segment ids < K_MAX; gt_prim [N] int types;
    pred_prim_per_point [N]: the type head's argmax, for the SIOU metric
    (GT types when absent). subset / generator: the mean-shift bandwidth
    subset (ops.mean_shift._subset_sqdist). spline_fit: a
    fitting.spline_apply.SplineFit, or None for no spline slots.

    spline_stride: stride of the cloud the decoders see (2: the
    reference's); residual_stride: of the points residuals and chamfers
    are measured on; siou_stride: of the SIOU metric's points only;
    ms_attempt_iterations: iterations of the escalation attempts (the
    accepted bandwidth always re-runs `iterations`). ablate: a subset of
    ABLATE_ARMS. `timer` splits the call into STAGES.
    """
    bad = set(ablate) - set(ABLATE_ARMS)
    if bad:
        raise ValueError(f"fitting_loss_shape: ablate {sorted(bad)} not in "
                         f"{ABLATE_ARMS}")
    emb = embedding / (torch.linalg.norm(embedding, dim=-1, keepdim=True)
                       + 1e-12)
    gt_oh = to_one_hot(gt_labels)
    gt_count = torch.sum(gt_oh, dim=0)
    if "ms" in ablate:
        # GT-segment clusters: each centre the mean embedding of its GT
        # segment, normalised by sqrt(sum + 1e-12) (an empty segment's zero
        # row has a finite gradient there, linalg.norm's is NaN)
        centers = (gt_oh.T @ emb) / (gt_count[:, None] + EPS)
        centers = centers / torch.sqrt(
            torch.sum(centers * centers, dim=-1, keepdim=True) + 1e-12)
        valid_k = gt_count > 0
        ms = MeanShiftResult(emb, torch.zeros(emb.shape[0],
                                              device=points.device),
                             gt_labels.to(torch.int64),
                             torch.tensor(0.1, device=points.device),
                             int(valid_k.sum()))
    else:
        with timer("mean_shift"):
            ms = guard_mean_shift(emb, quantile, num_samples=ms_num_samples,
                                  iterations=iterations, subset=subset,
                                  generator=generator, differentiable=True,
                                  attempt_iterations=ms_attempt_iterations)
            centers, valid_k = cluster_centers(ms, emb)
    with timer("matching"):
        with trace("matching.lap"):
            pred_oh = to_one_hot(ms.labels)
            if "ms" in ablate or "match" in ablate:
                cols = torch.arange(K_MAX, device=points.device)
            else:
                cols = solve_lap((1.0 - relaxed_iou(pred_oh, gt_oh)).detach()
                                 ).to(torch.int64)
        with trace("matching.weights"):
            weights_raw = centers @ emb.T                       # [K, N]
            pred_count = torch.sum(pred_oh, dim=0)
            valid = valid_k & (pred_count > 0) & (gt_count[cols] > 0)
            votes = gt_segment_prim_votes(gt_labels, gt_prim)   # [K, 10]
            seg_label = torch.argmax(votes[cols], dim=1)        # [K]
            w_norm = weights_normalize(weights_raw, ms.bandwidth, valid)
            gt_mask = (gt_labels[None, :] == cols[:, None]).to(torch.float32)
            p_res = points[::residual_stride]
            gt_mask_res = gt_mask[:, ::residual_stride]

    if "fits" in ablate:
        geom_res = torch.zeros(K_MAX, device=points.device)
    else:
        with timer("fits"):
            # the geometric fits on the stride-4 subsample (reference 2 x 2)
            params = fit_all_primitives_shared_points(
                points[::4], normals[::4], w_norm[:, ::4] + EPS)
            dists = residual_select(p_res, params,
                                    geom_type_from_label(seg_label))
            geom_res = torch.sum(dists * gt_mask_res, dim=1) / (
                torch.sum(gt_mask_res, dim=1) + EPS)

    is_spline = _isin(seg_label, SPLINE_LABELS_OPEN + SPLINE_LABELS_CLOSED)
    is_closed = _isin(seg_label, SPLINE_LABELS_CLOSED)
    is_geom = valid & ~is_spline

    # the spline slots: the first SPLINE_SLOTS valid spline segments, in
    # segment order like the reference
    spline_valid_seg = valid & is_spline
    in_cap = spline_valid_seg & (torch.cumsum(spline_valid_seg, 0) - 1
                                 < SPLINE_SLOTS)
    slot_seg = torch.argsort((~in_cap).to(torch.int32),
                             stable=True)[:SPLINE_SLOTS]
    slot_valid = in_cap[slot_seg]
    spline_used = torch.zeros(K_MAX, dtype=torch.bool, device=points.device)
    spline_res = torch.zeros(K_MAX, dtype=torch.float32, device=points.device)
    if spline_fit is not None:
        with timer("spline"):
            p2 = points[::spline_stride]
            w2 = w_norm[:, ::spline_stride] + EPS
            surfs = spline_fit.batched(
                p2.expand(SPLINE_SLOTS, *p2.shape), w2[slot_seg],
                is_closed[slot_seg])                        # [S, G, 3]
        with timer("chamfer"):
            # two-sided chamfer of the GT segment's points and the surface
            # (reference primitives.py:197-206, reduce=True), all slots in
            # one call each way
            m = gt_mask_res[slot_seg]                           # [S, Nr]
            d_ps = min_sqdist(p_res.expand(SPLINE_SLOTS, *p_res.shape),
                              surfs)
            d1 = torch.sum(d_ps * m, dim=1) / (torch.sum(m, dim=1) + EPS)
            d_sp = min_sqdist(surfs, p_res.expand(SPLINE_SLOTS,
                                                  *p_res.shape), x_mask=m)
            slot_res = 0.5 * (d1 + torch.mean(d_sp, dim=1))
            spline_res = spline_res.index_add(
                0, slot_seg, torch.where(slot_valid, slot_res, 0.0))
        spline_used[slot_seg] = slot_valid

    # separate_losses: degenerate residuals clamped, splines lamb-scaled
    res = torch.where(spline_used, spline_res, geom_res)
    res = torch.where(res > 1.0, 0.1, res)
    contributes = (is_geom | spline_used).to(torch.float32)
    geom_f, used_f = is_geom.to(torch.float32), spline_used.to(torch.float32)
    scaled = torch.where(spline_used, res * lamb, res)
    total = torch.sum(scaled * contributes) / (torch.sum(contributes) + EPS)
    g_loss = torch.sum(res * geom_f) / (torch.sum(geom_f) + EPS)
    s_loss = torch.sum(res * used_f) / (torch.sum(used_f) + EPS)

    if "siou" in ablate:
        zero = torch.mean(res).detach() * 0.0
        return FittingLossOut(total, g_loss, s_loss, zero, zero,
                              ms.num_clusters)
    with torch.no_grad(), timer("matching"), trace("matching.siou"):
        ss = siou_stride
        pp = gt_prim if pred_prim_per_point is None else pred_prim_per_point
        seg_iou, prim_iou = siou_matched_segments(
            gt_labels[::ss], ms.labels[::ss], pp[::ss], gt_prim[::ss],
            w_norm.T[::ss])
    return FittingLossOut(total, g_loss, s_loss, seg_iou, prim_iou,
                          ms.num_clusters)
