#!/usr/bin/env python3
"""Why normals-train-4card's sound gaps stand above normals-train's: the
reference's segmentation steps with each micro-batch's network run in the
ranks' slices (2 shapes each, forward and backward) against the reference
at the whole micro-batch, on one device, with no NCCL and no code of the
port.

    python3 benchmark/readings_slices.py --seeds 1,2 [--tiny] [--out f.jsonl]

One JSON line a seed: the check's gaps (benchmark/reference/compare) of
the sliced run against the reference ("sliced") and, for the first two
seeds, of the reference against itself ("again"); and at the first step
(the seeded start, its 3 micro-batches): the largest relative gap of the
embeddings, the kNN rows whose neighbour set differs in each of the 3
graphs, the triplet hinge terms that flip, and the gradient entries whose
sign flips (Adam's first step moves each by lr x its sign). --tiny cuts
the shapes to 300 points for the CPU. Nothing here is run by
benchmark/run.py.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.cells import CHECKED_STEPS  # noqa: E402
from benchmark.reference import compare, precision  # noqa: E402
from benchmark.reference import train as rt  # noqa: E402
from benchmark.reference.plain.ops import knn as knn_ops  # noqa: E402
from benchmark.traffic import ShapePool  # noqa: E402


def inputs(pool, mix, seeds, dev):
    """The cell's first CHECKED_STEPS steps' batches and generator
    (TrainingDriver.step_inputs)."""
    shapes = int(mix["batch"]) * int(mix["accum"])
    rng = np.random.RandomState(seeds["subsample"])
    out = []
    for s in range(CHECKED_STEPS):
        idx = pool.order[(s * shapes + np.arange(shapes)) % pool.size]
        pts, labels, normals, prim = pool.batch(idx)
        sel = rng.choice(pts.shape[1], min(int(mix["keep_points"]),
                                           pts.shape[1]), replace=False)
        out.append((pts[:, sel], labels[:, sel], normals[:, sel],
                    prim[:, sel]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seeds["torch"])
    return out, gen


def forward(model, x, per):
    """The network on x [B, ...] whole (per None) or in slices of `per`."""
    if per is None:
        return model(x)
    outs = [model(x[r:r + per]) for r in range(0, x.shape[0], per)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def steps(cfg, batches, gen, accum, batch, init, lr, dev, per):
    """benchmark.reference.train.seg_steps with the forward by `forward`."""
    model = rt.network(cfg, dev, init_seed=init)
    plan = []
    for b in batches:
        x, labels, prim = rt.inputs(b, dev)
        u_pts, u_pairs = rt.draw_triplet(accum * batch, gen, dev)
        micro = []
        for a in range(accum):
            s = slice(a * batch, (a + 1) * batch)

            def loss_fn(s=s, x=x, labels=labels, prim=prim, u_pts=u_pts,
                        u_pairs=u_pairs):
                emb, logp = forward(model, x[s], per)
                return (rt.triplet_loss(emb, labels[s], u_pts[s], u_pairs[s])
                        + rt.primitive_nll_loss(logp, prim[s]))
            micro.append(loss_fn)
        plan.append(micro)
    return rt.adam_run(model, plan, lr)


@contextlib.contextmanager
def recording(graphs: list):
    """Record each kNN graph's indices."""
    saved = (knn_ops.knn, knn_ops.knn_points_normals)

    def wrap(fn):
        def rec(*a, **k):
            out = fn(*a, **k)
            graphs.append(out.detach().clone())
            return out
        return rec
    knn_ops.knn, knn_ops.knn_points_normals = map(wrap, saved)
    try:
        yield
    finally:
        knn_ops.knn, knn_ops.knn_points_normals = saved


def triplet_recording(hinges: list, fn):
    """fn (the triplet loss) recording each hinge's sign."""
    def rec(*a, **k):
        relu = torch.relu

        def hinge(x):
            hinges.append((x > 0).detach().clone())
            return relu(x)
        torch.relu = hinge
        try:
            return fn(*a, **k)
        finally:
            torch.relu = relu
    return rec


def first_step(cfg, batches, gen, accum, batch, init, dev, per):
    """At the seeded start, the first step's micro-batches: embeddings,
    graphs [3 a forward], hinge signs and the mean gradient (flattened)."""
    model = rt.network(cfg, dev, init_seed=init)
    x, labels, prim = rt.inputs(batches[0], dev)
    u_pts, u_pairs = rt.draw_triplet(accum * batch, gen, dev)
    graphs, hinges, embs = [], [], []
    trip = triplet_recording(hinges, rt.triplet_loss)
    with recording(graphs):
        for a in range(accum):
            s = slice(a * batch, (a + 1) * batch)
            emb, logp = forward(model, x[s], per)
            embs.append(emb.detach())
            loss = (trip(emb, labels[s], u_pts[s], u_pairs[s])
                    + rt.primitive_nll_loss(logp, prim[s]))
            loss.backward()
    grad = torch.cat([p.grad.reshape(-1) / accum for p in model.parameters()])
    # graphs come 3 a forward: [micro][slice][layer] -> per layer, the
    # slices' rows joined in batch order
    layers = [[] for _ in range(3)]
    for i, g in enumerate(graphs):
        layers[i % 3].append(g)
    return (torch.cat(embs), [torch.cat(g) for g in layers], hinges, grad)


def discrete(a, b) -> dict:
    emb_a, graphs_a, hinges_a, grad_a = a
    emb_b, graphs_b, hinges_b, grad_b = b
    rows = []
    for ga, gb in zip(graphs_a, graphs_b):
        same = (ga.sort(-1).values == gb.sort(-1).values).all(-1)
        rows.append([int((~same).sum()), int(same.numel())])
    flips = sum(int((ha != hb).sum()) for ha, hb in zip(hinges_a, hinges_b))
    terms = sum(int(ha.numel()) for ha in hinges_a)
    nz = (grad_a != 0) | (grad_b != 0)
    sign = int((torch.sign(grad_a) != torch.sign(grad_b))[nz].sum())
    return {"emb_gap": compare.rel_gap(emb_b, emb_a),
            "knn_rows_differing": rows,
            "hinge_flips": [flips, terms],
            "grad_sign_flips": [sign, int(nz.sum())],
            "grad_gap_flat": compare.rel_gap(grad_b, grad_a)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    cell = harness.Cell(harness.load_spec(), "normals-train-4card")
    cfg, mix = cell.config, dict(cell.mix)
    if args.tiny:
        mix.update(points=300, keep_points=200, pool_shapes=12)
        torch.set_num_threads(2)
    accum, batch = int(mix["accum"]), int(mix["batch"])
    per = batch // int(mix["ranks"])
    lr = float(cfg["training"]["lr"])
    if dev.type == "cuda":
        harness.say(harness.card_line())
    pool = ShapePool(mix, 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        first = i < 2
        t0 = time.time()
        sd = harness.seeds(seed)
        pool.order = np.random.RandomState(sd["pool"]).permutation(pool.size)
        out = {"seed": seed, "per_rank": per}
        with precision():
            runs = {}
            plan = [("whole", None), ("sliced", per)]
            for name, p in plan + ([("again", None)] if first else []):
                batches, gen = inputs(pool, mix, sd, dev)
                runs[name] = steps(cfg, batches, gen, accum, batch,
                                   sd["init"], lr, dev, p)
            firsts = []
            for p in (None, per):
                batches, gen = inputs(pool, mix, sd, dev)
                firsts.append(first_step(cfg, batches, gen, accum, batch,
                                         sd["init"], dev, p))
        out["sliced"] = compare.training_gaps(runs["sliced"], runs["whole"])
        if "again" in runs:
            out["again"] = compare.training_gaps(runs["again"],
                                                 runs["whole"])
        out["first_step"] = discrete(*firsts)
        out["seconds"] = time.time() - t0
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
