"""One data-parallel e2e training step and the sharded inference over N
ranks: the counterpart of __graft_entry__.dryrun_multichip.

    python -m parsenet_tpu_torch.cli.dryrun_multichip N [--device cpu]
        [--points P] [--k K]

Runs the full e2e step (DGCNN -> mean-shift -> matching -> fits -> the
frozen SplineNet decoders of params/ -> residual loss -> gradients averaged
over the ranks -> Adam) at the JAX dry run's mid-scale dims (embedding 64,
k 16, 1,024 points, one shape a rank, make_shape_batch seed 0 with 3-6
segments), then eval.sharded.make_batched_eval of the stepped network, 5
mean-shift iterations, one shape a rank. Rank 0 prints the JAX dry run's
two lines:

    dryrun_multichip ok: {metric: value}
    dryrun_multichip inference ok: {residual, seg_iou, p_cov, sk_2}

N ranks are spawned (parallel.launch.spawn: NCCL, rank r on cuda:r;
gloo only with --device cpu); N = 1 runs in this process; under torchrun
the launched ranks are used. More ranks than cards raise. --points and
--k shrink the run (the CPU tests take 256 points and k 8).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.synthetic import make_shape_batch
from ..fitting.spline_apply import build_spline_fit
from ..models.dgcnn import PrimitivesEmbedding, init_flax_like
from ..parallel.launch import spawn
from ..parallel.mesh import make_mesh, shard_batch
from ..train.state import make_optimizer
from ..train.train_e2e import draw_e2e, make_e2e_step
from ..eval.sharded import make_batched_eval

EMB, K, POINTS = 64, 16, 1024
DEADLINE_S = 1800.0     # spawned ranks are killed past it


def run_rank(mesh, points: int = POINTS, k: int = K) -> list:
    """The dry run on this rank of `mesh` -> [train metrics, inference
    means] (dicts of floats, the same on every rank)."""
    dev = mesh.device
    b = mesh.shape["data"]
    model = PrimitivesEmbedding(emb_size=EMB, num_primitives=10, mode=5,
                                k=k)
    init_flax_like(model, torch.Generator().manual_seed(0))
    model.to(dev)
    spline_fit = build_spline_fit(grid=20, sample_grid=10, device=dev)
    optimizer = make_optimizer(model.parameters(), "adam", 1e-4)
    train_step, _ = make_e2e_step(model, spline_fit, optimizer,
                                  ms_num_samples=points, with_normals=True,
                                  mesh=mesh)
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(0), b, points, min_segments=3, max_segments=6)
    x = torch.as_tensor(np.concatenate([pts, normals], -1), dtype=torch.float32,
                        device=dev)
    lab = torch.as_tensor(labels, dtype=torch.int64, device=dev)
    pr = torch.as_tensor(prim, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    draws = draw_e2e(b, points, points, gen, dev)
    metrics = train_step(*(shard_batch(mesh, t)[None] for t in (x, lab, pr)),
                         [shard_batch(mesh, draws)], 1e-4)
    train = {key: float(v) for key, v in metrics.items()}
    model.eval()
    batched = make_batched_eval(model, spline_fit, mesh,
                                ms_num_samples=points, ms_iterations=5)
    sums = batched(pts.astype(np.float32), normals.astype(np.float32),
                   labels, prim, seed=2).cpu().numpy()
    infer = {name: float(sums[i] / b)
             for i, name in enumerate(("residual", "seg_iou", "p_cov",
                                       "sk_2"))}
    return [train, infer]


def dryrun(n: int, device=None, points: int = POINTS, k: int = K) -> list:
    """The dry run over n ranks -> rank 0's [train, inference] dicts."""
    if n == 1 or all(v in os.environ for v in ("RANK", "WORLD_SIZE")):
        mesh = make_mesh(n, device=device)
        try:
            return run_rank(mesh, points, k)
        finally:
            mesh.close()
    dev = torch.device("cuda" if device is None else device)
    return spawn(run_rank, n, (points, k), device=str(dev),
                 deadline=DEADLINE_S, threads=None if dev.type == "cuda"
                 else 1)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="One data-parallel e2e step and the sharded inference "
                    "over N ranks.")
    ap.add_argument("n", type=int, help="ranks (one a card)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (gloo ranks)")
    ap.add_argument("--points", type=int, default=POINTS)
    ap.add_argument("--k", type=int, default=K)
    args = ap.parse_args(argv)
    train, infer = dryrun(args.n, args.device, args.points, args.k)
    if int(os.environ.get("RANK", "0")) == 0:
        print("dryrun_multichip ok:", train, flush=True)
        print("dryrun_multichip inference ok:", infer, flush=True)


if __name__ == "__main__":
    main()
