#!/usr/bin/env python3
"""How far NMS clustering moves with the rounding of f32 mean-shift.

    python3 scripts/torch_ms_f32_agreement.py      # from a checkout's root

On the 8 stream-a embeddings of `chip_smoke.py` phase 3 (bench.py's stream
"a", seed 7, the shipped DGCNN weights, each at its own bandwidth), runs 50
mean-shift iterations four ways: the 3xTF32 K1 (`kernel`), the plain f32
version (`plain`), the plain f32 version with the key rows in another
order (`plain_perm`: the same sums, rounded in another order) and the plain
version in float64 (`f64`). Prints, per embedding, the NMS co-membership
and the max |d| of the shifted rows for pairs of them. Needs one CUDA card.
"""
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from parsenet_tpu_torch.core.guards import entry_device  # noqa: E402
from parsenet_tpu_torch.data.abc import normalize_points  # noqa: E402
from parsenet_tpu_torch.data.synthetic import make_shape_batch  # noqa: E402
from parsenet_tpu_torch.models.dgcnn import (  # noqa: E402
    load_primitives_embedding)
from parsenet_tpu_torch.ops import kernels  # noqa: E402
from parsenet_tpu_torch.ops import mean_shift as ms  # noqa: E402

PAIRS = (("kernel", "plain"), ("plain_perm", "plain"), ("f64", "plain"),
         ("kernel", "f64"), ("plain", "f64"), ("plain_perm", "f64"))


def main():
    dev = entry_device("cuda")
    pts, _, normals, _ = make_shape_batch(np.random.RandomState(7), 40,
                                          10000)
    for i in range(pts.shape[0]):
        pts[i], normals[i], _, _ = normalize_points(pts[i], normals[i])
    pts, normals = pts.astype(np.float32), normals.astype(np.float32)
    model = load_primitives_embedding(cs.PARAMS, mode=5, k=80, device=dev)
    gen_e = torch.Generator(device=dev)   # the bandwidth subsets, as phase 3
    gen_e.manual_seed(3)
    gen_p = torch.Generator(device=dev)   # the key orders
    gen_p.manual_seed(11)
    print(cs.nvidia_smi_line(), flush=True)
    for i in range(8):
        with torch.no_grad():
            e = model(torch.from_numpy(np.concatenate(
                [pts[i:i + 1], normals[i:i + 1]], -1)).to(dev))[0][0]
        e = (e / (torch.linalg.norm(e, dim=-1, keepdim=True)
                  + 1e-12)).contiguous()
        b = ms._initial_bandwidth(ms._subset_sqdist(e, 5000,
                                                    generator=gen_e), 0.015)
        outs = {"kernel": kernels.mean_shift_iterations(e, b, 50),
                "plain": kernels.mean_shift_iterations_plain(e, b, 50)}
        perm = torch.randperm(e.shape[0], device=dev, generator=gen_p)
        outs["plain_perm"] = kernels.mean_shift_iterations_plain(
            e[perm].contiguous(), b, 50)[torch.argsort(perm)]
        outs["f64"] = kernels.mean_shift_iterations_plain(
            e.double(), b.double(), 50).float()
        lab = {k: ms.nms(v, e, b)[1].cpu().numpy() for k, v in outs.items()}
        print(f"emb {i} bw {float(b):.5f}; " + "; ".join(
            f"co({a},{c}) {cs.co_membership(lab[a], lab[c]):.6f} max|d| "
            f"{float((outs[a] - outs[c]).abs().max()):.2e}"
            for a, c in PAIRS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
