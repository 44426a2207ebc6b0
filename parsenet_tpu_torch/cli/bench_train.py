"""Training-step throughput of the port (the counterpart of
scripts/bench_train.py).

    python -m parsenet_tpu_torch.cli.bench_train [seg|e2e|all] [--device cuda]

Times the segmentation step (triplet + NLL, gradient accumulation; the
network only) and the e2e step (network -> mean-shift (K1 f32 attempts)
-> matching (K2) -> fits -> frozen SplineNets -> slot chamfer (K3, K4 in
the backward) -> gradients -> Adam) at the reference's scales, from a
seeded initialisation on make_shape_batch(RandomState(0)) shapes, with the
committed decoders. One warm-up step, then the timed ones; the clock stops
on torch.cuda.synchronize(). Prints one JSON line a bench: metrics
torch_seg_train_shapes_per_sec and torch_e2e_train_shapes_per_sec. Each
detail holds the card's nvidia-smi name and power limit and the peak
device memory.

Knobs (environment), as scripts/bench_train.py reads them: BT_BATCH,
BT_ACCUM, BT_POINTS (seg: 2 x 7,000 points x accum 3; e2e: 1 x 8,000),
BT_BF16 (the bf16 network with bf16 gathers), BT_REMAT (EdgeConvs
recomputed in the backward), BT_MS_SAMPLES (5000), BT_FAST (the trainer's
FAST_STEP_KNOBS, on exact kNN graphs), BT_SPLINE_STRIDE, BT_RES_STRIDE,
BT_SIOU_STRIDE and BT_MS_ATT. Refused with an error that names them:
BT_KNN_RECALL > 0 (approx_max_k is a TPU primitive), BT_MS_PALLAS=0 (the
port's escalation attempts always run on K1 f32) and scripts/
bench_train.py's knob of stubbed stages (bench.STAGE_COSTS), unless
empty.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Mapping

import numpy as np
import torch

from ..core.guards import entry_device
from ..data.synthetic import make_shape_batch
from ..fitting.spline_apply import build_spline_fit
from ..losses.embedding import draw_triplet
from ..models.dgcnn import PrimitivesEmbedding, init_flax_like
from ..train.state import make_optimizer
from ..train.train_e2e import FAST_STEP_KNOBS, draw_e2e, make_e2e_step
from ..train.train_seg import make_step_fns
from .bench import STAGE_COSTS, card_line


def _refuse(env: Mapping[str, str]) -> None:
    if float(env.get("BT_KNN_RECALL", "0") or 0) > 0:
        raise ValueError(f"bench_train: BT_KNN_RECALL={env['BT_KNN_RECALL']}"
                         " cannot be honoured by the port: approx_max_k is "
                         "a TPU primitive; the port's kNN is exact")
    if env.get("BT_MS_PALLAS") == "0":
        raise ValueError("bench_train: BT_MS_PALLAS=0 cannot be honoured by "
                         "the port: its escalation attempts always run on "
                         "K1 f32")
    if env.get("BT_ABLATE"):
        raise ValueError(f"bench_train: BT_ABLATE={env['BT_ABLATE']} cannot "
                         f"be honoured by the port: {STAGE_COSTS}")


def _model(env: Mapping[str, str], dev) -> tuple:
    bf16 = env.get("BT_BF16", "0") == "1"
    remat = env.get("BT_REMAT", "0") == "1"
    model = PrimitivesEmbedding(
        emb_size=128, num_primitives=10, mode=5, k=80,
        dtype=torch.bfloat16 if bf16 else torch.float32, gather_bf16=bf16,
        remat=remat)
    init_flax_like(model, torch.Generator().manual_seed(0))
    return model.to(dev), bf16, remat


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def _emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def bench_seg(env: Mapping[str, str] = os.environ, steps: int = 5,
              device=None) -> dict:
    """The segmentation step at BT_BATCH x BT_POINTS x BT_ACCUM; `steps`
    timed steps after one warm-up step."""
    _refuse(env)
    dev = entry_device(device)
    batch = int(env.get("BT_BATCH", 2))
    accum = int(env.get("BT_ACCUM", 3))
    n_points = int(env.get("BT_POINTS", 7000))
    model, bf16, remat = _model(env, dev)
    opt = make_optimizer(model.parameters(), "adam")
    train_step, _ = make_step_fns(model, opt)
    pts, labels, normals, prim = make_shape_batch(np.random.RandomState(0),
                                                  batch * accum, n_points)
    x = torch.from_numpy(np.concatenate([pts, normals], -1).astype(
        np.float32).reshape(accum, batch, n_points, 6)).to(dev)
    lb = torch.from_numpy(labels.reshape(accum, batch, -1)).to(dev)
    pb = torch.from_numpy(prim.reshape(accum, batch, -1)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def step():
        u_pts, u_pairs = draw_triplet(accum * batch, gen, dev)
        return train_step(x, lb, pb, u_pts.reshape(accum, batch,
                                                   *u_pts.shape[1:]),
                          u_pairs.reshape(accum, batch, *u_pairs.shape[1:]),
                          0.01)

    _reset_peak(dev)
    step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step()
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    return _emit({
        "metric": "torch_seg_train_shapes_per_sec",
        "value": batch * accum / dt, "unit": "shapes/s",
        "detail": {"step_ms": dt * 1e3, "batch": batch, "accum": accum,
                   "points": n_points, "bf16": bf16, "remat": remat,
                   "steps": steps, "embed_loss": float(m["embed_loss"]),
                   "grad_ok": float(m["grad_ok"]),
                   "peak_mem_gib": _peak_gib(dev), "card": card_line(dev)}})


def bench_e2e(env: Mapping[str, str] = os.environ, steps: int = 3,
              device=None) -> dict:
    """The e2e step at BT_BATCH x BT_POINTS (5 mean-shift iterations);
    `steps` timed steps after one warm-up step."""
    _refuse(env)
    dev = entry_device(device)
    batch = int(env.get("BT_BATCH", 1))
    n_points = int(env.get("BT_POINTS", 8000))
    ms_samples = int(env.get("BT_MS_SAMPLES", 5000))
    fast = env.get("BT_FAST", "0") == "1"
    knobs = dict(FAST_STEP_KNOBS) if fast else {}
    strides = {k: int(env.get(e, knobs.get(k, d))) for k, e, d in (
        ("spline_stride", "BT_SPLINE_STRIDE", 2),
        ("residual_stride", "BT_RES_STRIDE", 1),
        ("siou_stride", "BT_SIOU_STRIDE", 1))}
    ms_att = int(env.get("BT_MS_ATT",
                         knobs.get("ms_attempt_iterations") or 0)) or None
    model, bf16, remat = _model(env, dev)
    opt = make_optimizer(model.parameters(), "adam")
    train_step, _ = make_e2e_step(
        model, build_spline_fit(grid=20, device=dev), opt, iterations=5,
        ms_num_samples=ms_samples, ms_attempt_iterations=ms_att, **strides)
    pts, labels, normals, prim = make_shape_batch(np.random.RandomState(0),
                                                  batch, n_points)
    x = torch.from_numpy(np.concatenate([pts, normals], -1).astype(
        np.float32)).to(dev)
    lb = torch.from_numpy(labels).to(dev)
    pb = torch.from_numpy(prim).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def step():
        draws = draw_e2e(batch, n_points, ms_samples, gen, dev)
        return train_step(x[None], lb[None], pb[None], [draws], 1e-4)

    _reset_peak(dev)
    step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step()
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    return _emit({
        "metric": "torch_e2e_train_shapes_per_sec",
        "value": batch / dt, "unit": "shapes/s",
        "detail": {"step_ms": dt * 1e3, "batch": batch, "points": n_points,
                   "bf16": bf16, "remat": remat, "ms_samples": ms_samples,
                   **strides, "ms_att": ms_att or 0, "ms_att_k1_f32": True,
                   "knn": "exact", "fast": fast, "steps": steps,
                   "res_loss": float(m["res_loss"]),
                   "grad_ok": float(m["grad_ok"]),
                   "peak_mem_gib": _peak_gib(dev), "card": card_line(dev)}})


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(
        description="Time the port's training steps "
                    "(scripts/bench_train.py's protocol).")
    ap.add_argument("which", nargs="?", default="all",
                    choices=("seg", "e2e", "all"))
    ap.add_argument("--device", default=device,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.which in ("seg", "all"):
        bench_seg(device=args.device)
    if args.which in ("e2e", "all"):
        bench_e2e(device=args.device)


if __name__ == "__main__":
    main()
