"""A/B the port's mean-shift variants on the card: K1's early exit (tol)
and bf16 dots, against the f32 fixed-count guard, on trained-model
embeddings. The port's counterpart of scripts/ab_mean_shift.py.

    python3 scripts/torch_ab_mean_shift.py [--device cuda]

Stream a's first 3 x 4 shapes (make_shape_batch(RandomState(7), 12,
10000), normalize_points) through the shipped DGCNN (params/
parsenet_e2e.npz), then the inference guard_mean_shift (quantile 0.015, 50
iterations, 5,000-point subset, the same subset draws in every variant) in
four variants: base (f32), tol (f32, tol 1e-6: K1_exit), bf16 (K1tc) and
bf16_tol (K1tc_exit). Prints each variant's ms a shape (host clock over 4
timed rounds after one warm-up round, synchronised) and its labels' agreement
with base: the share of equal labels, the co-membership of point pairs and
whether every shape has base's cluster count. The JAX script's "sortpath"
variant (a traced quantile, which takes the exact-sort bandwidth) has no
counterpart: the port's bandwidth statistic has one path.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from parsenet_tpu_torch.core.guards import entry_device  # noqa: E402
from parsenet_tpu_torch.data.abc import normalize_points  # noqa: E402
from parsenet_tpu_torch.data.synthetic import make_shape_batch  # noqa: E402
from parsenet_tpu_torch.models.dgcnn import (  # noqa: E402
    load_primitives_embedding)
from parsenet_tpu_torch.ops import kernels  # noqa: E402
from parsenet_tpu_torch.ops.mean_shift import guard_mean_shift  # noqa: E402

B, N, ROUNDS = 4, 10000, 3
VARIANTS = {"base": (False, 0.0), "tol": (False, 1e-6),
            "bf16": (True, 0.0), "bf16_tol": (True, 1e-6)}


def co_membership(a: np.ndarray, b: np.ndarray) -> float:
    """Share of point pairs on whose same-cluster relation a and b agree."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)

    def pairs(c):
        return float((c * (c - 1) // 2).sum())
    only = pairs(table.sum(1)) + pairs(table.sum(0)) - 2 * pairs(table)
    n = a.size
    return 1.0 - only / (n * (n - 1) / 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    dev = entry_device(ap.parse_args().device)
    pts, _, normals, _ = make_shape_batch(np.random.RandomState(7), ROUNDS * B,
                                          N)
    for i in range(ROUNDS * B):
        pts[i], normals[i], _, _ = normalize_points(pts[i], normals[i])
    x = torch.from_numpy(np.concatenate([pts, normals], -1).astype(
        np.float32)).to(dev)
    model = load_primitives_embedding(
        os.path.join(REPO, "params", "parsenet_e2e.npz"), device=dev)
    with torch.no_grad():
        emb = torch.cat([model(x[r * B:(r + 1) * B])[0]
                         for r in range(ROUNDS)])
    emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-12)
    subsets = torch.stack([torch.randperm(N, generator=torch.Generator()
                                          .manual_seed(i))[:5000]
                           for i in range(ROUNDS * B)]).to(dev)

    def run(bf16, tol):
        return [guard_mean_shift(emb[i].contiguous(), 0.015, num_samples=5000,
                                 iterations=50, bf16_dots=bf16,
                                 subset=subsets[i], tol=tol).labels.cpu()
                .numpy() for i in range(ROUNDS * B)]

    print(f"device {torch.cuda.get_device_name(0)}" if dev.type == "cuda"
          else f"device {dev}")
    results = {}
    for name, (bf16, tol) in VARIANTS.items():
        run(bf16, tol)                       # warm-up (and kernel build)
        kernels.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            labels = run(bf16, tol)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 4 / (ROUNDS * B) * 1000.0
        results[name] = labels
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        print(f"{name}: {ms:.2f} ms/shape, launches {launched}")
    base = results["base"]
    for name, labels in results.items():
        agree = float(np.mean([np.mean(a == b) for a, b in zip(labels, base)]))
        pairs = min(co_membership(a, b) for a, b in zip(labels, base))
        same_k = all(len(np.unique(a)) == len(np.unique(b))
                     for a, b in zip(labels, base))
        print(f"{name}: label agree {agree:.4f}, co-membership min "
              f"{pairs:.6f}, same_cluster_count {same_k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
