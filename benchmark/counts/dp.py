"""What the data-parallel segmentation step moves between ranks, and the
link it moves it over.

A step of train.train_seg.make_step_fns under a mesh all-reduces, in f32:
the flattened gradients once (Mesh.all_reduce_grads), the triplet loss's
normaliser once a micro-batch (one number, Mesh.all_sum) and the step's 3
metrics once (Mesh.all_mean). A ring all-reduce of b bytes over n ranks
sends and receives 2 (n - 1) / n x b bytes a rank, so its least time is
that over one rank's link bandwidth in one direction.
"""
from __future__ import annotations

# NVIDIA H100 SXM's NVLink 4 (NVIDIA's data sheet): 900 GB/s a card, both
# directions together, so 450e9 bytes a second in each direction. A host
# whose cards are joined by PCIe moves less, and the share then reads low.
NVLINK_BYTES = 450e9
STEP_METRICS = 3     # embed_loss, prim_loss, miou (train_seg.METRICS)


def seg_step_allreduce_bytes(parameters: int, accum: int) -> float:
    """f32 bytes all-reduced by one segmentation step of `accum`
    micro-batches of a model of `parameters` parameters."""
    return 4.0 * (parameters + accum + STEP_METRICS)


def allreduce_least_seconds(nbytes: float, ranks: int) -> float:
    """The least time of all-reducing `nbytes` over `ranks` ranks: each
    rank's 2 (ranks - 1) / ranks x nbytes at NVLINK_BYTES."""
    return nbytes * 2.0 * (ranks - 1) / ranks / NVLINK_BYTES
