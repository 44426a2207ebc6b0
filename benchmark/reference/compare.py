"""The numbers compared with their limits.

Inference cells, over a sample of the window's requests and each of their
shapes:
* net_gap: the network's outputs (embedding, type log-probabilities), the
  largest absolute gap over the largest absolute reference value, the worse
  of the two;
* iou_gap: the largest over the sampled shapes of a shape's larger gap of
  seg IoU and type IoU (each in [0, 1]): a cap on every shape;
* iou_mean_gap: the mean over the sampled shapes of that gap;
* residual_gap (the test protocol): the largest relative gap of the
  residual (over the reference's, or RESIDUAL_FLOOR where that is
  larger) over the shapes clustered alike (both IoUs within ALIKE of the
  reference's and as many clusters): the fits, the spline slots and the
  residual of the shapes whose clustering the reference shares; where no
  sampled shape is clustered alike it reads inf.
K1 rounds apart from the plain mean-shift, so a few points of a shape
cluster apart in up to half of the sound runs' shapes, each such shape's
IoU moving by up to an eighth and its residual by more than the fits
would; a shape clustered alike keeps its residual within a few per cent.
Training cells, over the first three steps:
* loss_gap: the largest relative gap of a step's loss;
* first_loss_gap: the same of the first step's loss alone;
* grad_gap: by the worst leaf, the gap between the norms of the first
  step's gradient, over the larger of the reference leaf's norm and the
  median leaf's;
* change_gap: the same of the parameters' change over the three steps;
* median_change_gap: the median over the leaves of that gap.
Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding, as a bias before a GroupNorm) are left out of the
gradient and change gaps. A cell is held to those of these numbers that
its limits name. Where a later step's clustering meets a near tie (the
e2e loss's mean-shift, matching and fits are discrete), a change of the
start by rounding moves that step's loss and every leaf's change by a
per cent or more: there the first step's loss and gradient stay at
rounding, the median leaf's change stays well under the control's, and
the worst leaf holds the gross faults (a leaf left unmoved or moved
double reads 1).
"""
from __future__ import annotations

import numpy as np
import torch

LEAF_RULE = 1e-3    # a leaf counts where its reference gradient norm is at
                    # least this share of the median leaf's
ALIKE = 1e-6        # IoUs this close are the same clustering, to rounding
RESIDUAL_FLOOR = 1e-3   # a residual's gap is taken relative to at least
                        # this: a thousandth of the shapes' scale (unit
                        # spread after canonicalisation); a fit closer
                        # than that is exact to rounding


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double().to(a.device)
    return float(torch.max(torch.abs(a - b)) / (torch.max(torch.abs(b))
                                                 + 1e-30))


def net_gap(prog: list, ref: list) -> float:
    """prog, ref: [(embedding, type log-probs)] of the same requests."""
    return max(max(rel_gap(p[0], r[0]), rel_gap(p[1], r[1]))
               for p, r in zip(prog, ref))


def shape_iou_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """prog, ref: [shapes, 2] seg and type IoU of the same shapes -> each
    shape's larger gap (inf where either side is not finite)."""
    gap = np.abs(np.asarray(prog, np.float64)
                 - np.asarray(ref, np.float64)).max(axis=1)
    return np.nan_to_num(gap, nan=np.inf)


def inference_gaps(prog_iou, ref_iou, prog_k=None, ref_k=None,
                   prog_res=None, ref_res=None) -> dict:
    """The per-shape numbers of the sampled shapes: *_iou [shapes, 2], *_k
    [shapes] cluster counts, *_res [shapes] residuals (the test protocol;
    None elsewhere)."""
    gap = shape_iou_gaps(prog_iou, ref_iou)
    out = {"iou_gap": float(gap.max()), "iou_mean_gap": float(gap.mean())}
    if prog_res is not None:
        alike = (gap <= ALIKE) & (np.asarray(prog_k) == np.asarray(ref_k))
        p = np.asarray(prog_res, np.float64)[alike]
        r = np.asarray(ref_res, np.float64)[alike]
        rel = np.abs(p - r) / np.maximum(np.abs(r), RESIDUAL_FLOOR)
        out["residual_gap"] = (float(np.nan_to_num(rel, nan=np.inf).max())
                               if alike.any() else float("inf"))
    return out


def leaves_counted(ref_grad: dict) -> list:
    norms = np.array(list(ref_grad.values()))
    med = float(np.median(norms))
    return [k for k, v in ref_grad.items() if v >= LEAF_RULE * med]


def leaf_gaps(prog: dict, ref: dict, leaves: list) -> list:
    """For each leaf of `leaves`: |prog norm - ref norm| over max(ref leaf
    norm, median ref leaf norm)."""
    med = float(np.median([ref[k] for k in leaves]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves]


def training_gaps(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [3 floats], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    leaves = leaves_counted(ref["grad"])
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not np.all(
            np.isfinite(prog["losses"])):
        losses = [np.inf] * max(len(losses), 1)
    change = leaf_gaps(prog["change"], ref["change"], leaves)
    return {"loss_gap": float(max(losses)),
            "first_loss_gap": float(losses[0]),
            "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"], leaves)),
            "change_gap": max(change),
            "median_change_gap": float(np.median(change))}
