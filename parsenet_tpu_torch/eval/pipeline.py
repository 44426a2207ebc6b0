"""Inference and evaluation pipeline.

Counterpart of parsenet_tpu/eval/pipeline.py:

* `predict_segmentation`: network forward, mean-shift clustering (quantile
  0.015, 50 iterations, K1), per-point types, SIOU over LAP-matched
  segments (K2). Batched: the network runs on [B, N], clustering per shape,
  then SIOU for the whole batch (one K2 launch for its B matrices).
* `reconstruct_shape`: hard one-hot membership, per-segment type by vote,
  all four geometric fits per segment, surface grids; with a `spline_fit`
  (fitting.spline_apply.build_spline_fit) the 12 largest spline segments
  are preprocessed (ops.preprocess), decoded by the open and closed
  SplineNets and replace their geometric fallback, as the JAX package's
  eval_preprocess=True path does; then the residual (the spline slots' part
  one batched K3 call a shape) and the reference-protocol coverage (K3).
  spline_fit=None is the JAX package's BENCH_ABLATE=splines arm: every
  spline segment keeps its geometric fallback; eval_preprocess=False its
  `preprocess` arm (each slot sampled with replacement to SPLINE_PTS
  points, no outlier removal or upsampling); profile_skip its `coverage`
  and `residual` arms (those sections return zeros).
* `batch_metrics` / `run_batch`: one batch through both, as bench.py's
  shape_pipeline does, with its BENCH_ABLATE arms (ABLATE_ARMS).
* `coverage_metrics`: p_cov, sk_1 and sk_2 of any surface sample
  collection against the input (K3 both ways).

Random draws (the bandwidth subset, the spline slots' packing and final
draws, the coverage uniforms) are arguments or come from an explicit
torch.Generator on the run's device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.guards import EPS, entry_device
from ..core.profiling import StageTimer, trace
from ..ops.chamfer import min_sqdist
from ..fitting.spline_apply import CLOSED_PTS, OPEN_PTS
from ..ops.mean_shift import guard_mean_shift
from ..ops.preprocess import BUF, eval_segment_points
from ..ops.primitive_dist import (GEOM_CONE, GEOM_CYLINDER, GEOM_SPHERE,
                                  geom_type_from_label, residual_select)
from ..ops.primitive_fits import AllPrimParams, fit_all_primitives_shared_points
from ..ops.sampling import (sample_cone, sample_cylinder, sample_plane,
                            sample_sphere)
from ..ops.segmentation import (K_MAX, primitive_type_per_segment,
                                remap_primitive_labels,
                                siou_matched_segments, to_one_hot)

SURF_GRID = 64       # per-primitive sample grid (64^2 = 4096 samples)
COV_SAMPLES = 10000  # coverage sample budget (reference: test.py:153)
COV_TRIM_EPS = 0.1   # mesh bit-mapping epsilon (reference: test.py:137)
COV_TRIM_POINTS = 2500  # input subsample the trim test runs against

EVAL_SPLINE_SLOTS = 12  # spline segments decoded a shape, largest first
SPLINE_PTS = 1536       # rows a slot with eval_preprocess=False
# bench.py's BENCH_ABLATE sections: ms (GT labels, no clustering or SIOU),
# siou (clustering runs, SIOU does not), recon (no reconstruction),
# splines (no spline slots), preprocess (eval_preprocess=False), coverage
# and residual (profile_skip)
ABLATE_ARMS = ("ms", "siou", "recon", "splines", "preprocess", "coverage",
               "residual")
PROFILE_SKIP = ("coverage", "residual")
STAGES = ("dgcnn", "mean_shift", "siou", "fits_sampling",
          "spline_preprocess", "spline_decode", "spline_residual", "residual",
          "coverage")


_NO_TIMER = StageTimer(False)


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    """`a` on `device`; a copy from the host to the card waits for the
    card's queue (span sync.h2d_input)."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a))
    if a.device.type == "cpu" and torch.device(device).type == "cuda":
        with trace("sync.h2d_input"):
            return a.to(device=device, dtype=dtype)
    return a.to(device=device, dtype=dtype)


def _network_input(model, pts, nrm):
    """What `model` reads: points only where its encoder is mode 0, else
    points and normals [B, N, 6]."""
    if getattr(getattr(model, "encoder", None), "mode", 5) != 5:
        return pts
    return torch.cat([pts, nrm], dim=-1)


class SegmentationPrediction(NamedTuple):
    labels: torch.Tensor      # [B, N] cluster id per point
    pred_prim: torch.Tensor   # [B, N] predicted primitive type per point
    embedding: torch.Tensor   # [B, N, D]
    seg_iou: torch.Tensor     # [B]
    prim_iou: torch.Tensor    # [B]
    num_clusters: list        # [B] ints


@torch.no_grad()
def predict_segmentation(model, points, normals, gt_labels, gt_prim,
                         quantile: float = 0.015, iterations: int = 50,
                         ms_num_samples: int = 5000, ms_bf16: bool = False,
                         skip_siou: bool = False,
                         subsets: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         device=None,
                         timer: StageTimer = _NO_TIMER
                         ) -> SegmentationPrediction:
    """Segment a batch of shapes. points/normals [B, N, 3], gt_labels /
    gt_prim [B, N]; model maps [B, N, 6] (points and normals) to
    (embedding, type log-probs) when its encoder is mode 5, else [B, N, 3]
    (points only, mode 0), as the JAX entry point picks the input by the
    config's mode; a callable without a DGCNN encoder takes [B, N, 6].

    subsets [B, S]: the bandwidth-statistic rows per shape, else drawn from
    `generator` (see ops.mean_shift._subset_sqdist). ms_bf16: bf16 operands
    in the mean-shift products, the bench's setting (f32 by default).
    skip_siou (BENCH_ABLATE=siou): clustering runs, the SIOU matching does
    not, and seg_iou / prim_iou are 1.
    """
    with trace("entry.predict_segmentation"):
        dev = entry_device(device)
        pts = _as_tensor(points, dev, torch.float32)
        nrm = _as_tensor(normals, dev, torch.float32)
        gt_labels = _as_tensor(gt_labels, dev, torch.int64)
        gt_prim = _as_tensor(gt_prim, dev, torch.int64)
        with timer("dgcnn"):
            emb, prim_logp = model(_network_input(model, pts, nrm))
            pred_prim = torch.argmax(prim_logp, dim=-1)
            embn = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True)
                          + 1e-12)
        labels, ks = [], []
        for b in range(pts.shape[0]):
            with timer("mean_shift"):
                ms = guard_mean_shift(
                    embn[b], quantile, num_samples=ms_num_samples,
                    iterations=iterations, bf16_dots=ms_bf16,
                    subset=None if subsets is None else subsets[b],
                    generator=generator)
            labels.append(ms.labels)
            ks.append(ms.num_clusters)
        labels = torch.stack(labels)
        if skip_siou:
            one = torch.ones(pts.shape[0], device=dev)
            return SegmentationPrediction(labels, pred_prim, emb, one, one, ks)
        with timer("siou"):   # draws nothing: one LAP launch for the batch
            seg_iou, prim_iou = siou_matched_segments(
                gt_labels, labels, pred_prim, gt_prim, to_one_hot(labels))
        return SegmentationPrediction(labels, pred_prim, emb, seg_iou,
                                      prim_iou, ks)


class Reconstruction(NamedTuple):
    surface_points: torch.Tensor  # [K, S, 3] sampled predicted surfaces
    surface_mask: torch.Tensor    # [K] validity
    seg_of_slot: torch.Tensor     # [K] segment id of each surface
    residual: torch.Tensor        # mean sqrt distance of points to own surface
    p_cov: torch.Tensor           # two-sided sqrt chamfer (pred <-> input)
    sk_1: torch.Tensor            # fraction of input within 0.01 of prediction
    sk_2: torch.Tensor            # ... within 0.02
    area_weights: torch.Tensor    # [K, S] local area element per sample


def _area_weights(surf: torch.Tensor) -> torch.Tensor:
    """|du x dv| per sample of row-major g x g grids [K, g^2, 3] -> [K, g^2]
    (np.gradient's central / one-sided differences)."""
    k, g2, _ = surf.shape
    g = int(round(g2 ** 0.5))
    s = surf.reshape(k, g, g, 3)
    tu = torch.gradient(s, dim=1)[0]
    tv = torch.gradient(s, dim=2)[0]
    return torch.linalg.norm(torch.linalg.cross(tu, tv), dim=-1).reshape(k, g2)


def _fit_and_sample(points, normals, pred_labels, pred_prim):
    """Per-segment fits and surface grids of one shape. Returns (params,
    seg_type [K] in the eval taxonomy, counts [K], geom_type [K], surf
    [K, G^2, 3], area [K, G^2])."""
    with trace("fits.segments"):
        oh = to_one_hot(pred_labels)                      # [N, K]
        counts = torch.sum(oh, dim=0)
        prim_oh = to_one_hot(remap_primitive_labels(pred_prim), 10)
        seg_type = primitive_type_per_segment(prim_oh, oh)
        geom_type = geom_type_from_label(seg_type)
        seg_mask = oh.T                                   # [K, N]
    with trace("fits.solve"):
        params = fit_all_primitives_shared_points(points, normals,
                                                  seg_mask + EPS)
    with trace("fits.sample"):
        t = geom_type[:, None, None]
        surf = sample_plane(params.plane.normal, params.plane.offset, points,
                            seg_mask, SURF_GRID)
        surf = torch.where(t == GEOM_SPHERE, sample_sphere(
            params.sphere.center, params.sphere.radius, points, seg_mask,
            SURF_GRID), surf)
        surf = torch.where(t == GEOM_CYLINDER, sample_cylinder(
            params.cylinder.axis, params.cylinder.center,
            params.cylinder.radius, points, seg_mask, SURF_GRID), surf)
        surf = torch.where(t == GEOM_CONE, sample_cone(
            params.cone.apex, params.cone.axis, params.cone.theta, points,
            seg_mask, SURF_GRID), surf)
        area_w = _area_weights(surf)
    return params, seg_type, counts, geom_type, surf, area_w


def slot_segments(seg_type, counts, n_slots: int):
    """The segments of the spline slots: the largest of a spline type (2
    open, 9 closed) with >= 100 points first, ties to the lower segment id,
    as lax.top_k orders them, then the rest. -> (slot_seg [n_slots],
    slot_valid [n_slots])."""
    spline_ok = ((seg_type == 2) | (seg_type == 9)) & (counts >= 100)
    rank_key = torch.where(spline_ok, counts, -1.0)
    slot_seg = torch.sort(rank_key, descending=True,
                          stable=True).indices[:n_slots]
    return slot_seg, spline_ok[slot_seg]


def sample_segment_points(points, labels, counts, segs, u):
    """Fixed-size with-replacement samples of the points of each segment in
    `segs` (parsenet_tpu/eval/pipeline.py:_sample_segment_points): points
    [N, 3], labels [N], counts [K_MAX] points a segment, segs [S], u [S, M]
    uniforms in [0, 1) -> [S, M, 3]. The points are stably sorted by label
    and draw m of segment s takes its floor(u * count)-th point."""
    n = points.shape[0]
    order = torch.sort(labels, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts
    pos = (starts[segs][:, None] + torch.floor(
        u * torch.clamp(counts[segs], min=1.0)[:, None])).to(torch.int64)
    return points[order[torch.clamp(pos, 0, n - 1)]]


def _spline_slots(points, pred_labels, seg_type, counts, spline_fit,
                  slot_uniforms, eval_preprocess, timer):
    """The spline slots of one shape (parsenet_tpu/eval/pipeline.py:
    212-271), each preprocessed to 1,800 rows (eval_preprocess; the draws
    slot_uniforms = (u_pack, u_draw)) or sampled with replacement to
    SPLINE_PTS rows (slot_uniforms = u [S, SPLINE_PTS]) and decoded. ->
    (slot_seg [S], slot_valid [S], surfaces [S, sample_grid^2, 3]); invalid
    slots are decoded too, and left unused."""
    n_slots = (slot_uniforms[0] if eval_preprocess else slot_uniforms
               ).shape[0]
    slot_seg, slot_valid = slot_segments(seg_type, counts, n_slots)
    is_closed = seg_type[slot_seg] == 9
    with timer("spline_preprocess"):
        if eval_preprocess:
            a_max = torch.where(is_closed, CLOSED_PTS, OPEN_PTS)
            pts_s = eval_segment_points(
                points, pred_labels[None, :] == slot_seg[:, None], a_max,
                *slot_uniforms, n_out=CLOSED_PTS)
        else:
            pts_s = sample_segment_points(points, pred_labels, counts,
                                          slot_seg, slot_uniforms)
    with timer("spline_decode"):
        if eval_preprocess:
            surf_s = spline_fit.batched_eval(pts_s, is_closed)
        else:
            surf_s = spline_fit.batched(pts_s, torch.ones(
                pts_s.shape[:2], device=pts_s.device), is_closed)
    return slot_seg, slot_valid, surf_s


def _place_slots(surf, area_w, slot_seg, slot_valid, surf_s):
    """Valid slots' surfaces replace their segments' geometric ones, tiled
    (or cut) to the geometric sample count; their area weights are taken on
    the decoder's own grid first and each row rescaled to its true total
    (parsenet_tpu/eval/pipeline.py:246-271)."""
    w_s = _area_weights(surf_s)
    true_tot = torch.sum(w_s, dim=1, keepdim=True)
    g2, s2 = surf.shape[1], surf_s.shape[1]
    reps = max(1, -(-g2 // s2))
    surf_s = surf_s.repeat(1, reps, 1)[:, :g2]
    w_s = w_s.repeat(1, reps)[:, :g2]
    w_s = w_s * true_tot / (torch.sum(w_s, dim=1, keepdim=True) + EPS)
    surf, area_w = surf.clone(), area_w.clone()
    surf[slot_seg] = torch.where(slot_valid[:, None, None], surf_s,
                                 surf[slot_seg])
    area_w[slot_seg] = torch.where(slot_valid[:, None], w_s,
                                   area_w[slot_seg])
    return surf, area_w


def _slot_distances(points, pred_labels, slot_seg, slot_valid, slot_surf):
    """Squared distance of each point to its own spline slot's samples, all
    slots in one batched K3 call ([S, N] against [S, G^2]), and where that
    applies: the points of segments in a valid slot. -> (used [N] bool,
    d [N])."""
    n, s = points.shape[0], slot_seg.shape[0]
    lab = torch.clamp(pred_labels, max=K_MAX - 1)
    with trace("residual.slot_distances"):
        d_slot = min_sqdist(points.expand(s, n, 3), slot_surf)    # [S, N]
    with trace("residual.slot_select"):
        slot_of_seg = torch.zeros(K_MAX, dtype=torch.int64,
                                  device=points.device)
        slot_of_seg[slot_seg] = torch.arange(s, device=points.device)
        used = torch.zeros(K_MAX, dtype=torch.bool, device=points.device)
        used[slot_seg] = slot_valid
        return used[lab], d_slot[slot_of_seg[lab],
                                 torch.arange(n, device=points.device)]


def _residual(points, pred_labels, params: AllPrimParams, geom_type, valid,
              spline_d=None):
    """Mean sqrt distance of each point to its own segment's surface over
    points of valid segments: the closed-form distance to its primitive
    (reference ResidualLoss, primitives.py:36-44), or, where `spline_d`
    (from _slot_distances) says so, the min distance to its spline slot's
    samples. Labels past K_MAX - 1 read the last segment, as JAX's clamped
    gather."""
    n = points.shape[0]
    lab = torch.clamp(pred_labels, max=K_MAX - 1)
    d_own = residual_select(points, params, geom_type)[
        lab, torch.arange(n, device=points.device)]
    if spline_d is not None:
        d_own = torch.where(spline_d[0], spline_d[1], d_own)
    pt_valid = valid[lab].to(torch.float32)
    return (torch.sum(torch.sqrt(torch.clamp(d_own, min=1e-12)) * pt_valid)
            / (torch.sum(pt_valid) + EPS))


def fixed_order_cdf(w: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of w [M] whose float sums follow one order on
    every device and in every run: w (zero-padded to a multiple of K_MAX,
    the segments of a shape's area weights) viewed as [K_MAX, M / K_MAX],
    a scan along each row (torch.cumsum over the last dim of a 2-d
    tensor: one block a row, a fixed tree, where a 1-d CUDA cumsum is a
    look-back scan whose sums follow the blocks' timing), plus each row's
    offset, the rows' totals before it summed as one product with a
    strictly lower-triangular matrix of ones."""
    m, rows = w.shape[0], K_MAX
    cols = -(-m // rows)
    within = torch.cumsum(torch.nn.functional.pad(w, (0, rows * cols - m))
                          .reshape(rows, cols), dim=1)
    tri = torch.tril(torch.ones((rows, rows), dtype=w.dtype,
                                device=w.device), diagonal=-1)
    return (within + (tri @ within[:, -1])[:, None]).reshape(-1)[:m]


@torch.no_grad()
def protocol_coverage(points: torch.Tensor, flat_surf: torch.Tensor,
                      flat_w: torch.Tensor, uniforms: torch.Tensor):
    """Reference-protocol coverage (p_cov, sk_1, sk_2) of one shape.

    points [N, 3]; flat_surf [M, 3] surface samples with area-times-validity
    weights flat_w [M]; uniforms [COV_SAMPLES] in [0, 1). Surface farther
    than COV_TRIM_EPS from the input (tested against a 2,500-point input
    subsample) is trimmed, COV_SAMPLES samples are drawn area-weighted
    (their cdf from `fixed_order_cdf`, so a draw repeats from run to run on
    the card), and the one-sided sqrt chamfers are measured both ways.
    """
    n = points.shape[0]
    sub = points[::max(1, n // COV_TRIM_POINTS)].contiguous()
    trim_d = min_sqdist(flat_surf, sub)
    flat_w = flat_w * (trim_d <= COV_TRIM_EPS ** 2)
    cdf = fixed_order_cdf(flat_w)
    u = uniforms.to(torch.float32) * cdf[-1]
    pick = torch.clamp(torch.searchsorted(cdf, u), 0, flat_surf.shape[0] - 1)
    surf_s = flat_surf[pick]
    d_in = torch.sqrt(torch.clamp(min_sqdist(points, surf_s), min=1e-12))
    d_out = torch.sqrt(torch.clamp(min_sqdist(surf_s, points), min=1e-12))
    cov = 0.5 * (torch.mean(d_in) + torch.mean(d_out))
    sk_1 = torch.mean((d_in < 0.01).to(torch.float32))
    sk_2 = torch.mean((d_in < 0.02).to(torch.float32))
    return cov, sk_1, sk_2


@torch.no_grad()
def reconstruct_shape(points, normals, pred_labels, pred_prim,
                      uniforms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      spline_fit=None, slot_uniforms=None,
                      eval_preprocess: bool = True, profile_skip=(),
                      device=None,
                      timer: StageTimer = _NO_TIMER) -> Reconstruction:
    """Eval-mode fitting of one clustered shape.

    points/normals [N, 3]; pred_labels [N] cluster ids; pred_prim [N]
    per-point types. uniforms [COV_SAMPLES] for the coverage draw, else
    drawn from `generator`. spline_fit: fitting.spline_apply.SplineFit, or
    None for the spline-free arm. slot_uniforms: (u_pack [S, N], u_draw
    [S, min(N, BUF)]) in [0, 1), the packing and final draws of S slots,
    or with eval_preprocess=False the with-replacement draws u [S,
    SPLINE_PTS]; else drawn from `generator` after the coverage uniforms
    for EVAL_SPLINE_SLOTS slots. profile_skip: a subset of PROFILE_SKIP
    whose sections (the residual with the slots' distances, the coverage)
    are not run and return zeros.
    """
    bad = set(profile_skip) - set(PROFILE_SKIP)
    if bad:
        raise ValueError(f"reconstruct_shape: profile_skip {sorted(bad)} "
                         f"not in {PROFILE_SKIP}")
    dev = entry_device(device)
    pts = _as_tensor(points, dev, torch.float32)
    nrm = _as_tensor(normals, dev, torch.float32)
    pred_labels = _as_tensor(pred_labels, dev, torch.int64)
    pred_prim = _as_tensor(pred_prim, dev, torch.int64)
    n = pts.shape[0]
    if (uniforms is None or (spline_fit is not None and slot_uniforms is None)
            ) and generator is None:
        raise ValueError("reconstruct_shape: pass the draws or a generator")
    if uniforms is None:
        uniforms = torch.rand(COV_SAMPLES, generator=generator, device=dev)
    if spline_fit is not None and slot_uniforms is None:
        slot_uniforms = (
            (torch.rand((EVAL_SPLINE_SLOTS, n), generator=generator,
                        device=dev),
             torch.rand((EVAL_SPLINE_SLOTS, min(n, BUF)),
                        generator=generator, device=dev))
            if eval_preprocess else
            torch.rand((EVAL_SPLINE_SLOTS, SPLINE_PTS), generator=generator,
                       device=dev))
    with timer("fits_sampling"):
        params, seg_type, counts, geom_type, surf, area_w = _fit_and_sample(
            pts, nrm, pred_labels, pred_prim)
        valid = counts >= 20                              # reference drop rule
    spline_d = None
    skip_residual = "residual" in profile_skip
    if spline_fit is not None:
        slot_uniforms = (tuple(_as_tensor(u, dev, torch.float32)
                               for u in slot_uniforms) if eval_preprocess
                         else _as_tensor(slot_uniforms, dev, torch.float32))
        slot_seg, slot_valid, surf_s = _spline_slots(
            pts, pred_labels, seg_type, counts, spline_fit, slot_uniforms,
            eval_preprocess, timer)
        with timer("spline_decode"), trace("decode.place"):
            surf, area_w = _place_slots(surf, area_w, slot_seg, slot_valid,
                                        surf_s)
        if not skip_residual:
            with timer("spline_residual"):
                spline_d = _slot_distances(pts, pred_labels, slot_seg,
                                           slot_valid, surf[slot_seg])
    if skip_residual:
        residual = torch.zeros((), device=dev)
    else:
        with timer("residual"):
            residual = _residual(pts, pred_labels, params, geom_type, valid,
                                 spline_d)
    with timer("coverage"):
        return _finish_coverage(pts, surf, valid, area_w, residual,
                                _as_tensor(uniforms, dev),
                                "coverage" in profile_skip)


def _finish_coverage(points, surf, valid, area_w, residual, uniforms,
                     skip: bool = False) -> Reconstruction:
    """Coverage over every valid segment's area-weighted surface samples
    (reference segment_utils.py:83-123, test.py:153), then the result;
    zeros with `skip`."""
    if skip:
        z = torch.zeros((), device=points.device)
        return Reconstruction(surf, valid,
                              torch.arange(K_MAX, device=points.device),
                              residual, z, z, z, area_w)
    flat_w = (valid[:, None] * area_w).reshape(-1)
    cov, sk_1, sk_2 = protocol_coverage(points, surf.reshape(-1, 3), flat_w,
                                        uniforms)
    return Reconstruction(surf, valid,
                          torch.arange(K_MAX, device=points.device), residual,
                          cov, sk_1, sk_2, area_w)


METRICS = ("residual", "p_cov", "sk_1", "sk_2", "seg_iou", "prim_iou")


@torch.no_grad()
def batch_metrics(model, points, normals, labels, prim,
                  generator: torch.Generator, ms_bf16: bool = True,
                  spline_fit=None, ablate=(), device=None,
                  timer: StageTimer = _NO_TIMER) -> dict:
    """One batch of shapes through the main path, as bench.py's
    shape_pipeline: predict_segmentation then reconstruct_shape per shape,
    with the spline slots of `spline_fit` (None: the spline-free arm) and
    the BENCH_ABLATE arms in `ablate` (ABLATE_ARMS; `splines` is
    spline_fit=None, which the caller passes). points/normals [B, N, 3],
    labels/prim [B, N]; `generator` lives on the run's device and gives
    every draw. Returns {metric: [B] tensor on the device} for METRICS,
    without a host fetch, and num_clusters, a list of ints. The `ms` arm
    reconstructs the GT segments with the network's types (seg_iou and
    prim_iou 1, no clusters); `recon` returns zeros for the
    reconstruction's metrics."""
    with trace("entry.batch_metrics"):
        bad = set(ablate) - set(ABLATE_ARMS)
        if bad:
            raise ValueError(f"batch_metrics: ablate {sorted(bad)} not in "
                             f"{ABLATE_ARMS}")
        dev = entry_device(device)
        pts = _as_tensor(points, dev, torch.float32)
        nrm = _as_tensor(normals, dev, torch.float32)
        b_n = pts.shape[0]
        if "ms" in ablate:
            with timer("dgcnn"):
                emb, prim_logp = model(_network_input(model, pts, nrm))
            one = torch.ones(b_n, device=dev)
            pred = SegmentationPrediction(_as_tensor(labels, dev, torch.int64),
                                          torch.argmax(prim_logp, dim=-1), emb,
                                          one, one, [0] * b_n)
        else:
            pred = predict_segmentation(
                model, pts, nrm, labels, prim, ms_bf16=ms_bf16,
                ms_num_samples=min(5000, pts.shape[1]),
                skip_siou="siou" in ablate, generator=generator, device=dev,
                timer=timer)
        out = {"seg_iou": pred.seg_iou, "prim_iou": pred.prim_iou,
               "num_clusters": list(pred.num_clusters)}
        if "recon" in ablate:
            z = torch.zeros(b_n, device=dev)
            return {**out, **{k: z for k in METRICS[:4]}}
        skip = tuple(a for a in ablate if a in PROFILE_SKIP)
        recs = [reconstruct_shape(pts[b], nrm[b], pred.labels[b],
                                  pred.pred_prim[b], generator=generator,
                                  spline_fit=spline_fit,
                                  eval_preprocess="preprocess" not in ablate,
                                  profile_skip=skip, device=dev, timer=timer)
                for b in range(b_n)]
        for k in METRICS[:4]:
            out[k] = torch.stack([getattr(r, k) for r in recs])
        return out


def run_batch(model, points, normals, labels, prim,
              generator: torch.Generator, ms_bf16: bool = True,
              spline_fit=None, ablate=(), device=None,
              timer: StageTimer = _NO_TIMER) -> dict:
    """`batch_metrics` with every metric fetched to the host: per-shape
    lists of METRICS and num_clusters."""
    out = batch_metrics(model, points, normals, labels, prim, generator,
                        ms_bf16=ms_bf16, spline_fit=spline_fit,
                        ablate=ablate, device=device, timer=timer)
    return {k: (v if k == "num_clusters" else v.tolist())
            for k, v in out.items()}


@torch.no_grad()
def coverage_metrics(points: torch.Tensor, flat_surf: torch.Tensor,
                     flat_mask: torch.Tensor,
                     flat_w: Optional[torch.Tensor] = None):
    """Coverage of a surface sample collection (parsenet_tpu/eval/
    pipeline.py:362-379). points [N, 3], flat_surf [M, 3], flat_mask [M]
    (> 0 keeps a sample), flat_w [M] area weights of the surface -> points
    side (default flat_mask, uniform). Returns (p_cov, sk_1, sk_2)."""
    if flat_w is None:
        flat_w = flat_mask
    d_in = torch.sqrt(torch.clamp(min_sqdist(points, flat_surf, flat_mask),
                                  min=1e-12))
    d_out = torch.sqrt(torch.clamp(min_sqdist(flat_surf, points), min=1e-12))
    cov = 0.5 * (torch.mean(d_in)
                 + torch.sum(d_out * flat_w) / (torch.sum(flat_w) + EPS))
    return (cov, torch.mean((d_in < 0.01).to(torch.float32)),
            torch.mean((d_in < 0.02).to(torch.float32)))
