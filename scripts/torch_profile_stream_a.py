"""Profile one batch of stream a on the card, spline slots included: device
time by kernel and by named part of the spline path, and the device's idle
share of the wall time.

    python3 scripts/torch_profile_stream_a.py [--batches 3] [--root DIR]

Runs bench.py's stream a (make_shape_batch(RandomState(7), ...),
normalize_points, batches of 4 at 10,000 points, bf16 mean-shift, the
shipped params and SplineNets) through eval.pipeline.run_batch: the first
batches warm up, the last runs under torch.profiler. Prints the 30 rows of
the largest device time, then each named range (the preprocessing steps,
standardize and its eigh3, the kNN of the DGCNN and the SplineNets
together, the EdgeConvs, the surface sampling; the SIOU stage's one-hots,
relaxed IoU, type votes and LAP, and the LAP's own steps where the tree has
them as functions) with its host time and the device span of its kernels,
and the idle share: 1 - (union of the kernels' intervals) / wall. --root
profiles another checkout of the port (an older tree, for a before/after
in one call); a range whose function that tree lacks is left out.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 4, 10000


def name_range(owner, attr: str, label: str) -> None:
    """Wrap owner.attr so each call is a profiler range named `label`."""
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    setattr(owner, attr, wrapped)


def idle_share(prof, wall_us: float) -> tuple[int, float]:
    """(device kernels, 1 - union of their intervals / wall)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, start, end = 0.0, None, None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        busy += end - start
    return len(spans), 1.0 - busy / wall_us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=3,
                    help="batches run; the last one is profiled")
    ap.add_argument("--root", default=REPO,
                    help="checkout whose parsenet_tpu_torch is profiled")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from parsenet_tpu_torch.core.guards import entry_device
    from parsenet_tpu_torch.data.abc import normalize_points
    from parsenet_tpu_torch.data.synthetic import make_shape_batch
    from parsenet_tpu_torch.eval import pipeline as tp
    from parsenet_tpu_torch.fitting import spline_apply as sa
    from parsenet_tpu_torch.models import splinenet as sn
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    from parsenet_tpu_torch.ops import hungarian as hg
    from parsenet_tpu_torch.ops import knn, linalg
    from parsenet_tpu_torch.ops import preprocess as pp
    from parsenet_tpu_torch.ops import segmentation as seg
    from parsenet_tpu_torch.ops import standardize as st
    assert tp.__file__.startswith(os.path.abspath(args.root)), tp.__file__
    dev = entry_device("cuda")
    for owner, attr in ((tp, "siou_matched_segments"), (seg, "to_one_hot"),
                        (seg, "relaxed_iou"),
                        (seg, "primitive_type_per_segment"),
                        (seg, "solve_lap"), (hg, "lap_benefit"),
                        (hg, "auction_assign"), (hg, "complete_assignment"),
                        (hg, "lap_assign")):
        if attr in owner.__dict__:   # as the tree's solve_lap calls them
            name_range(owner, attr,
                       f"R {owner.__name__.split('.')[-1]}.{attr}")
    for owner, attr in ((pp, "pack_segment"),
                        (pp, "statistical_inliers_packed"), (pp, "repack"),
                        (pp, "nn_centroid_upsample"), (pp, "draw_fixed"),
                        (pp, "topk_first"), (st, "rotation_matrix_a_to_b"),
                        (linalg, "eigh3"), (sa, "standardize_points"),
                        (sa, "unstandardize_points"), (sa, "sample_surface"),
                        (knn, "knn"), (sn.EdgeConvBN, "forward")):
        name_range(owner, attr, f"R {owner.__name__.split('.')[-1]}.{attr}")
    pts, labels, normals, prim = make_shape_batch(np.random.RandomState(7),
                                                  args.batches * B, N)
    for i in range(args.batches * B):
        pts[i], normals[i], _, _ = normalize_points(pts[i], normals[i])
    pts, normals = pts.astype(np.float32), normals.astype(np.float32)
    model = load_primitives_embedding(
        os.path.join(args.root, "params", "parsenet_e2e.npz"), device=dev)
    fit = sa.build_spline_fit(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batches = [slice(b * B, (b + 1) * B) for b in range(args.batches)]
    for s in batches[:-1]:
        tp.run_batch(model, pts[s], normals[s], labels[s], prim[s], gen,
                     spline_fit=fit, device=dev)
    torch.cuda.synchronize()
    s = batches[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tp.run_batch(model, pts[s], normals[s], labels[s], prim[s], gen,
                     spline_fit=fit, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"{torch.cuda.get_device_name(0)}; profiled batch: "
          f"{1000.0 * wall:.1f} ms for {B} shapes (profiler on)")
    table = prof.key_averages()
    print(table.table(sort_by="cuda_time_total", row_limit=30,
                      max_name_column_width=60))
    for e in sorted((e for e in table if e.key.startswith("R ")),
                    key=lambda e: e.key):
        print(f"{e.key}: {e.count} calls, host {e.cpu_time_total / 1e3:.2f} "
              f"ms, device span {e.device_time_total / 1e3:.2f} ms")
    kernels, idle = idle_share(prof, wall * 1e6)
    print(f"{kernels} device kernels; idle share of the wall time "
          f"{idle:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
