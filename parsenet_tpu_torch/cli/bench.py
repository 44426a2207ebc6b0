"""End-to-end inference throughput of the port (the counterpart of the root
bench.py).

    python -m parsenet_tpu_torch.cli.bench [--device cuda]

Times the full inference path a shape at 10,000 points: the DGCNN forward
(k 80), mean-shift (50 iterations, quantile 0.015, NMS and the bandwidth
guard; K1 bf16, or K1 f32 with BENCH_MS_BF16=0), SIOU matching (K2), the
fits and surface samples, the 12 spline slots (preprocess, SplineNets) and
the residual and coverage (K3): the work of generate_predictions + test a
shape. Shapes are eval stream a (make_shape_batch seed 7, canonicalised by
normalize_points) or b (seed 1013); every draw comes from one torch
generator of seed GENERATOR_SEED on the run's device. 2 warm-up batches,
then BENCH_ITERS timed ones; the four metric sums of each batch are fetched
one batch behind, and the clock stops after the last fetch.

Prints ONE JSON line, {"metric": "torch_abc_shapes_per_hour_e2e", "value":
shapes/hour, "unit": "shapes/hour", "detail": {...}}: bench.py's detail
fields plus the card's name and power limit (nvidia-smi) and the seeds.
There is no vs_baseline: its yardstick, 1,250 shapes/hour a chip, is a
TPU target. With a trained model at 10,000 points on stream a and no
ablation the configs/quality_floors.json "bench" floors apply; a run that
misses them exits 1 after printing.

Knobs (environment), as bench.py reads them: BENCH_POINTS (10000),
BENCH_BATCH (4), BENCH_ITERS (8), BENCH_STREAM (a | b), BENCH_PARAMS,
BENCH_SPLINE_DIR, BENCH_MS_BF16 (1), BENCH_DGCNN_BF16 (0: the bf16 network
of models.dgcnn), BENCH_GATHER_BF16 (0), BENCH_ABLATE (a comma list of
eval.pipeline.ABLATE_ARMS) and BENCH_WATCHDOG_S (3600; 0 = off: past it
the bench prints a zero line and exits 2). Knobs the port cannot honour
raise an error that names them (REFUSED): BENCH_SHARD=1 (several cards),
BENCH_PREFLIGHT=1 (the TPU relay's probe) and PARSENET_KNN_RECALL
(approx_max_k; the port's kNN is exact).

Weights: an explicit BENCH_PARAMS npz (missing or not fitting the network:
an error), else logs/checkpoints/parsenet_e2e.npz, then
logs/checkpoints/parsenet_seg_normals.npz (the port's trainers save there),
else params/parsenet_e2e.npz, all relative to the working directory, else
a seeded initialisation (no floors). Decoders: BENCH_SPLINE_DIR's
checkpoints/{open,closed}_splinenet.npz (both must exist), else those of
logs/checkpoints where both exist, else the committed params/.

A reduced CPU run (`--device cpu`, BENCH_POINTS 256, BENCH_BATCH 2,
BENCH_ITERS 1) drives every path through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.checkpoint import load_npz_params
from ..core.guards import entry_device
from ..data.abc import normalize_points
from ..data.synthetic import make_shape_batch
from ..eval.pipeline import ABLATE_ARMS, batch_metrics
from ..fitting.spline_apply import build_spline_fit, trained_spline_fit
from ..models.dgcnn import PrimitivesEmbedding, init_flax_like, params_from_jax

METRIC = "torch_abc_shapes_per_hour_e2e"
WARMUP = 2              # batches
STREAM_SEEDS = {"a": 7, "b": 1013}
GENERATOR_SEED = 1      # the torch generator of every draw
FLOORS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "configs", "quality_floors.json")
CHECKPOINTS = ("logs/checkpoints/parsenet_e2e.npz",
               "logs/checkpoints/parsenet_seg_normals.npz",
               "params/parsenet_e2e.npz")
# knob -> (values the port refuses, why); None refuses any setting
REFUSED = {
    "BENCH_SHARD": (("1",), "sharding the batch over several cards is not "
                    "ported (multi-GPU comes last)"),
    "BENCH_PREFLIGHT": (("1",), "the relay preflight probes a remote TPU"),
    "PARSENET_KNN_RECALL": (None, "approx_max_k is a TPU primitive; the "
                            "port's kNN is exact"),
}


def settings(env: Mapping[str, str] = os.environ) -> dict:
    """The bench's knobs from `env`, checked before any setup: an invalid
    BENCH_STREAM or ablation arm and every refused knob raise ValueError
    naming the knob."""
    for knob, (values, why) in REFUSED.items():
        v = env.get(knob)
        if v is not None and (values is None or v in values):
            raise ValueError(f"bench: {knob}={v} cannot be honoured by the "
                             f"port: {why}")
    stream = env.get("BENCH_STREAM", "a")
    if stream not in STREAM_SEEDS:
        raise ValueError(f"bench: BENCH_STREAM={stream!r} invalid; allowed "
                         "values: 'a' (primary gate stream), 'b' (disjoint "
                         "promotion-noise stream)")
    ablate = tuple(a for a in env.get("BENCH_ABLATE", "").split(",") if a)
    bad = [a for a in ablate if a not in ABLATE_ARMS]
    if bad:
        raise ValueError(f"bench: BENCH_ABLATE arms {bad} unknown; allowed: "
                         f"{ABLATE_ARMS}")
    return {
        "points": int(env.get("BENCH_POINTS", "10000")),
        "batch": int(env.get("BENCH_BATCH", "4")),
        "iters": int(env.get("BENCH_ITERS", "8")),
        "stream": stream,
        "params": env.get("BENCH_PARAMS") or None,
        "spline_dir": env.get("BENCH_SPLINE_DIR") or None,
        "ms_bf16": env.get("BENCH_MS_BF16", "1") == "1",
        "dgcnn_bf16": env.get("BENCH_DGCNN_BF16", "0") == "1",
        "gather_bf16": env.get("BENCH_GATHER_BF16", "0") == "1",
        "ablate": ablate,
        "watchdog_s": float(env.get("BENCH_WATCHDOG_S", "3600")),
    }


def _loads(path: str, model: PrimitivesEmbedding) -> Optional[dict]:
    """The state dict of the npz at `path`, or None where it is missing or
    does not fit `model`."""
    if not os.path.exists(path):
        return None
    try:
        return params_from_jax(load_npz_params(path), model)
    except Exception as e:   # an unreadable or mismatched file
        print(f"bench: WARNING {path} does not fit the network ({e}); "
              "ignoring", file=sys.stderr)
        return None


def load_trained_params(model: PrimitivesEmbedding,
                        explicit: Optional[str] = None):
    """Load the trained weights into `model` by the resolution order of the
    module docstring -> (source path or None, trained). An explicit path
    that is missing or does not fit raises."""
    if explicit:
        sd = _loads(explicit, model)
        if sd is None:
            raise ValueError(f"bench: BENCH_PARAMS={explicit} missing or "
                             "incompatible: refusing to silently measure a "
                             "different model")
        model.load_state_dict(sd)
        return explicit, True
    for path in CHECKPOINTS:
        sd = _loads(path, model)
        if sd is not None:
            model.load_state_dict(sd)
            return path, True
    print("bench: WARNING no trained checkpoint; seeded initialisation, "
          "quality floors skipped", file=sys.stderr)
    init_flax_like(model, torch.Generator().manual_seed(0))
    return None, False


def spline_decoders(spline_dir: Optional[str], device):
    """(SplineFit, source) of the decoders: BENCH_SPLINE_DIR's, which must
    hold both npz files, else trained_spline_fit("logs")'s."""
    if spline_dir:
        ck = os.path.join(spline_dir, "checkpoints")
        if not all(os.path.exists(os.path.join(ck, f"{n}_splinenet.npz"))
                   for n in ("open", "closed")):
            raise ValueError(
                f"bench: BENCH_SPLINE_DIR={spline_dir} is explicitly set but "
                "checkpoints/{open,closed}_splinenet.npz are not both there: "
                "refusing to silently fall back to the shipped decoders")
        return build_spline_fit(params_dir=ck, device=device), ck
    own = all(os.path.exists(f"logs/checkpoints/{n}_splinenet.npz")
              for n in ("open", "closed"))
    return (trained_spline_fit("logs", device=device),
            "logs/checkpoints" if own else "params")


def card_line(dev: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    a CUDA run's card ("cpu" for a CPU run)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or f"nvidia-smi failed: {out.stderr}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def stream_shapes(stream: str, n_shapes: int, n_points: int):
    """n_shapes eval shapes of `stream`, canonicalised as ABCDataset.get_test
    feeds the network -> (points, labels, normals, prim) numpy."""
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(STREAM_SEEDS[stream]), n_shapes, n_points)
    for i in range(n_shapes):
        pts[i], normals[i], _, _ = normalize_points(pts[i], normals[i])
    return (pts.astype(np.float32), labels, normals.astype(np.float32),
            prim)


def run(cfg: dict, device=None) -> dict:
    """One bench run with settings `cfg` (see `settings`) on `device` (None
    = "cuda") -> the JSON record, with "quality_ok" in its detail."""
    dev = entry_device(device)
    floors = json.load(open(FLOORS_PATH))["bench"]
    ablate = cfg["ablate"]
    model = PrimitivesEmbedding(
        emb_size=128, num_primitives=10, mode=5, k=80,
        dtype=torch.bfloat16 if cfg["dgcnn_bf16"] else torch.float32,
        gather_bf16=cfg["gather_bf16"])
    params_src, trained = load_trained_params(model, cfg["params"])
    model.to(dev).eval()
    spline_fit, spline_src = spline_decoders(cfg["spline_dir"], dev)
    if "splines" in ablate:
        spline_fit = None
    b_n, iters = cfg["batch"], cfg["iters"]
    pts, labels, normals, prim = stream_shapes(
        cfg["stream"], (WARMUP + iters) * b_n, cfg["points"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(GENERATOR_SEED)

    def one_batch(b):
        s = slice(b * b_n, (b + 1) * b_n)
        out = batch_metrics(model, pts[s], normals[s], labels[s], prim[s],
                            gen, ms_bf16=cfg["ms_bf16"],
                            spline_fit=spline_fit, ablate=ablate, device=dev)
        return torch.stack([out[k].sum() for k in
                            ("residual", "seg_iou", "p_cov", "sk_2")])

    for b in range(WARMUP):
        one_batch(b).cpu()
    sums = np.zeros(4)
    t0 = time.perf_counter()
    pending = []
    for b in range(WARMUP, WARMUP + iters):
        pending.append(one_batch(b))
        if len(pending) > 1:          # fetch one batch behind
            sums += pending.pop(0).cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    while pending:
        sums += pending.pop(0).cpu().numpy()
    dt = time.perf_counter() - t0

    n_shapes = iters * b_n
    residual, seg_iou, p_cov, sk_2 = (float(v) / n_shapes for v in sums)
    floors_applied = (trained and cfg["points"] == 10000
                      and cfg["stream"] == "a" and not ablate)
    quality_ok = (not floors_applied) or (
        seg_iou >= floors["seg_iou_min"] and residual <= floors["residual_max"]
        and sk_2 >= floors["sk_2_min"])
    return {
        "metric": METRIC,
        "value": n_shapes / dt * 3600.0,
        "unit": "shapes/hour",
        "detail": {
            "per_shape_ms": 1000.0 * dt / n_shapes,
            "batch": b_n, "devices": 1, "num_points": cfg["points"],
            "stream": cfg["stream"], "residual": residual,
            "seg_iou": seg_iou, "p_cov": p_cov, "sk_2": sk_2,
            "trained_params": trained, "params_src": params_src,
            "dgcnn_bf16": cfg["dgcnn_bf16"],
            "gather_bf16": cfg["gather_bf16"], "ms_bf16": cfg["ms_bf16"],
            "ablate": ",".join(ablate), "quality_ok": quality_ok,
            "floors_applied": floors_applied, "spline_src": spline_src,
            "floors": floors,
            "card": card_line(dev), "device": str(dev),
            "stream_seed": STREAM_SEEDS[cfg["stream"]],
            "generator_seed": GENERATOR_SEED,
            "timed_batches": iters, "warmup_batches": WARMUP,
        },
    }


def _watchdog(seconds: float) -> None:
    print(json.dumps({
        "metric": METRIC, "value": 0.0, "unit": "shapes/hour",
        "detail": {"error": f"watchdog: no result within {seconds:.0f}s"}}),
        flush=True)
    os._exit(2)


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(
        description="Time the port's inference path (bench.py's protocol).")
    ap.add_argument("--device", default=device,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = settings()
    entry_device(args.device)
    timer = None
    if cfg["watchdog_s"] > 0:
        timer = threading.Timer(cfg["watchdog_s"], _watchdog,
                                (cfg["watchdog_s"],))
        timer.daemon = True
        timer.start()
    rec = run(cfg, args.device)
    if timer is not None:
        timer.cancel()
    print(json.dumps(rec), flush=True)
    d = rec["detail"]
    if not d["quality_ok"]:
        print(f"bench: QUALITY FLOOR VIOLATED: seg_iou {d['seg_iou']:.4f} "
              f"(floor {d['floors']['seg_iou_min']}), residual "
              f"{d['residual']:.5f} (ceiling {d['floors']['residual_max']}),"
              f" sk_2 {d['sk_2']:.4f} (floor {d['floors']['sk_2_min']})",
              file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
