"""FLOPs of SplineNet training steps, counted as benchmark.counts counts
them: products only, 2 x m x n x k each.

A patch of m points through the closed or open SplineNet forward is
counts.splinenet_forward_flops: four kNN graphs' score products, the
EdgeConvs' two maps each, conv5 and the head. The backward needs about
twice the dense products (the gradients of each layer's input and of its
weights) and none of the kNN scores, which take no gradient. The loss's
products (the 40 x 40 surface samples and the chamfer's distances) are
under 0.3% of a step and left out.
"""
from __future__ import annotations

from . import mm, splinenet_forward_flops


def splinenet_dense_flops(m: int, closed: bool, grid: int = 20) -> float:
    """The forward's products apart from the kNN scores: the EdgeConvs'
    maps, conv5 and the head on the pooled vector."""
    chans = (128, 256, 256, 512) if closed else (64, 64, 128, 256)
    knn, c_in = 0.0, 3
    for c in chans:
        knn += mm(m, m, c_in)
        c_in = c
    return splinenet_forward_flops(m, closed, grid) - knn


def spline_train_flops(m: int, closed: bool, grid: int = 20) -> float:
    """One patch of m points through a training step: the forward and twice
    its dense products for the backward."""
    return (splinenet_forward_flops(m, closed, grid)
            + 2.0 * splinenet_dense_flops(m, closed, grid))


def spline_train_flops_per_shape(points: list, closed: bool,
                                 grid: int = 20) -> float:
    """The mean over steps of a patch's training FLOPs, `points` the point
    count each step drew."""
    return (sum(spline_train_flops(m, closed, grid) for m in points)
            / max(len(points), 1))
