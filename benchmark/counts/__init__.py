"""Operation and byte counts from shapes, and the card's peaks.

Every count is of the work the model needs at the given shapes, not of
what an implementation does: products are counted as 2 x m x n x k FLOPs
and nothing else is (element-wise work, reductions and the kNN selections
are left out), so no implementation of the same work can read above the
peak through these counts. Mean-shift's products are counted at the dense
bf16 peak whatever the precision a version computes in.
"""
from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
# sparsity, at the full 700 W power limit): bf16 / fp16 tensor cores (every
# FLOP is held to this rate, whatever the precision it runs in) and HBM3.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# ex2 a second on the MUFU units: 132 SMs x 16 a clock (compute capability
# 9.0) at 1.83 GHz, the clock at which 132 x 4,096 bf16 FLOP a clock give
# the 989 TFLOP/s above
MUFU_EX2 = 132 * 16 * 1.83e9


def mm(m: int, n: int, k: int) -> float:
    """FLOPs of an [m, k] x [k, n] product."""
    return 2.0 * m * n * k


def dgcnn_forward_flops(n: int, k: int = 80, emb: int = 128,
                        prims: int = 10, mode: int = 5) -> float:
    """One shape of n points through PrimitivesEmbedding: the three kNN
    graphs' score products (points and normals 3 + 3 wide, then the 64-wide
    features twice) and every dense layer. The EdgeConv weights act on the
    points before the gather (its two [C, 64..128] maps a layer), which is
    the least the layer needs."""
    c_in = 6 if mode == 5 else 3
    knn = (mm(n, n, 3) * (2 if mode == 5 else 1) + mm(n, n, 64)
           + mm(n, n, 64))
    edge = 2 * (mm(n, 64, c_in) + mm(n, 64, 64) + mm(n, 128, 64))
    dense = (mm(n, 1024, 256) + mm(n, 512, 1280) + mm(n, 256, 512)
             + mm(n, 256, 256) + mm(n, emb, 256) + mm(n, 256, 256)
             + mm(n, prims, 256))
    return knn + edge + dense


def splinenet_forward_flops(m: int, closed: bool, grid: int = 20) -> float:
    """One slot of m points through a SplineNet (open 64/64/128/256, closed
    128/256/256/512 channels): four kNN graphs' score products, the
    EdgeConvs' two maps each, conv5 and the head on the pooled vector."""
    chans = (128, 256, 256, 512) if closed else (64, 64, 128, 256)
    c_in, flops = 3, 0.0
    for c in chans:
        flops += mm(m, m, c_in) + 2 * mm(m, c, c_in)
        c_in = c
    flops += mm(m, 1024, sum(chans))
    flops += mm(1, 1024, 1024) * 2 + mm(1, 3 * grid * grid, 1024)
    return flops


def mean_shift_counts(n: int, d: int, iterations: int) -> dict:
    """Gaussian mean-shift of n unit rows of width d: each iteration's two
    [n, n] x d products, its n^2 exponentials, and X read and m written
    once (f32)."""
    return {"flops": iterations * 2 * mm(n, n, d),
            "exps": float(iterations) * n * n,
            "bytes": 2.0 * n * d * 4}


def least_seconds(counts: dict) -> float:
    """The least time the card could take for `counts`: the largest of the
    FLOPs at the bf16 peak, the exponentials at the MUFU rate and the
    bytes at HBM bandwidth."""
    return max(counts.get("flops", 0.0) / PEAK_FLOPS,
               counts.get("exps", 0.0) / MUFU_EX2,
               counts.get("bytes", 0.0) / PEAK_BYTES)


def clustering_flops(n: int, d: int, iterations: int, subset: int) -> float:
    """One accepted bandwidth's clustering of a shape: the bandwidth
    subset's [S, S] product, the iterations and NMS's two [n, n] products."""
    return (mm(subset, subset, d) + mean_shift_counts(n, d, iterations)[
        "flops"] + 2 * mm(n, n, d))


def protocol_flops_per_shape(cfg: dict, n: int) -> float:
    """The test protocol of one shape: the network, the clustering and
    every spline slot through both decoders (open on its first 1,500
    preprocessed rows, closed on all 1,800)."""
    ms = cfg["mean_shift"]
    sl = cfg["spline_slots"]
    return (dgcnn_forward_flops(n, cfg["network"]["k"])
            + clustering_flops(n, cfg["network"]["emb_size"],
                               ms["iterations"], min(ms["subset"], n))
            + sl["slots"] * (
                splinenet_forward_flops(sl["open_points"], False, sl["grid"])
                + splinenet_forward_flops(sl["closed_points"], True,
                                          sl["grid"])))


def segment_flops_per_shape(cfg: dict, n: int) -> float:
    """generate_predictions of one shape: the network and the clustering."""
    ms = cfg["mean_shift"]
    return (dgcnn_forward_flops(n, cfg["network"]["k"])
            + clustering_flops(n, cfg["network"]["emb_size"],
                               ms["iterations"], min(ms["subset"], n)))


def seg_train_flops_per_shape(cfg: dict, n: int) -> float:
    """One shape of a segmentation step: the network's forward and its
    backward, taken as twice the forward."""
    return 3.0 * dgcnn_forward_flops(n, cfg["network"]["k"])


def e2e_train_flops_per_shape(cfg: dict, n: int) -> float:
    """One shape of an e2e step: the network forward and backward (3x the
    forward), the bandwidth subset, one attempt's iterations, the accepted
    bandwidth's iterations forward and backward (3x), NMS twice, and each
    training slot through both frozen decoders forward and back to their
    inputs (2x the forward)."""
    tr = cfg["e2e_training"]
    d, it = cfg["network"]["emb_size"], tr["iterations"]
    m = n // tr["spline_stride"]
    ms_it = mean_shift_counts(n, d, it)["flops"]
    return (3.0 * dgcnn_forward_flops(n, cfg["network"]["k"])
            + mm(min(tr["subset"], n), min(tr["subset"], n), d)
            + ms_it + 3.0 * ms_it + 2 * 2 * mm(n, n, d)
            + tr["spline_slots"] * 2.0 * (
                splinenet_forward_flops(m, False, cfg["spline_slots"]["grid"])
                + splinenet_forward_flops(m, True,
                                          cfg["spline_slots"]["grid"])))
