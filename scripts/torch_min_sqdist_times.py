#!/usr/bin/env python3
"""Eager and device times of the port's min-sqdist pair, K3 (forward) and
K4 (backward), at the main paths' shapes, for one checkout of the port; to
compare two checkouts on one card, run it once for each, in turns.

    python3 scripts/torch_min_sqdist_times.py [--root DIR] [--out FILE]

DIR (default: this repository) is the checkout whose parsenet_tpu_torch is
built and timed; the timing code is this repository's chip_smoke.py
(`time_k3`, `time_k4`: CUDA events around back-to-back eager calls, and
around replays of the calls captured in a CUDA graph). Shapes: a stream-a
shape's three K3 calls (204,800 surface samples against 2,500 points, and
10,000 x 10,000 both ways) and the SplineNet training call 36 x (700 vs
1,600), K4 on that call's argmins. The inputs are made from seed 0 and
are the same for every checkout. Prints the card and one JSON line; --out
writes the JSON there too. Needs one CUDA card.
"""
import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_min_sqdist_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    kernels = importlib.import_module("parsenet_tpu_torch.ops.kernels")
    assert kernels.__file__.startswith(os.path.abspath(args.root)), \
        kernels.__file__
    synthetic = importlib.import_module("parsenet_tpu_torch.data.synthetic")
    dev = torch.device("cuda")
    build_s = kernels.build_kernels()

    rs = np.random.RandomState(0)
    pts = synthetic.make_shape_batch(rs, 2, 10000)[0].astype(np.float32)
    p0, p1 = (torch.from_numpy(p).to(dev) for p in pts)
    surf = (p1.repeat(21, 1)[:204800]
            + 0.01 * torch.from_numpy(rs.randn(204800, 3).astype(
                np.float32)).to(dev)).contiguous()
    samp = surf[torch.from_numpy(rs.randint(0, 204800, 10000)).to(dev)]
    calls = [(surf, p0[::4].contiguous()), (p0, samp.contiguous()),
             (samp.contiguous(), p0)]
    tq = torch.from_numpy(rs.randn(36, 700, 3).astype(np.float32)).to(dev)
    tx = torch.from_numpy(rs.randn(36, 1600, 3).astype(np.float32)).to(dev)
    g = torch.from_numpy(rs.rand(36, 700).astype(np.float32)).to(dev)

    def k3_all():
        out = []
        for q, x in calls + [(tq, tx)]:
            d_k, i_k = kernels.min_sqdist_with_idx(q, x)
            d_p, i_p = kernels.min_sqdist_with_idx_plain(q, x)
            t = cs.time_k3(kernels, q, x, 50 if q.dim() == 3 else 10)
            t["shape"] = list(q.shape[:-1]) + [x.shape[-2]]
            t["max_abs_err"] = float((d_k - d_p).abs().max())
            t["index_agreement"] = float((i_k == i_p).float().mean())
            out.append(t)
            print(f"  K3 {t['shape']}: " + cs.k3_line(t)
                  + f", max |d| {t['max_abs_err']:.3e}", flush=True)
        return out

    res = {"root": os.path.abspath(args.root), "device":
           torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
           "build_s": build_s, "K3": k3_all()}
    idx = kernels.min_sqdist_with_idx_plain(tq, tx)[1]
    res["K4"] = cs.time_k4(kernels, tq, tx, idx, g, 50)
    dq_k, dx_k = kernels.min_sqdist_bwd(tq, tx, idx, g)
    dq_p, dx_p = kernels.min_sqdist_bwd_plain(tq, tx, idx, g)
    res["K4"]["dq_bitwise"] = bool(torch.equal(dq_k, dq_p))
    res["K4"]["dx_max_abs_err"] = float((dx_k - dx_p).abs().max())
    print(f"  K4 {list(tq.shape[:-1])} vs {tx.shape[1]}: kernel "
          f"{res['K4']['ms']:.4f} ms eager as MinSqdist calls it, "
          f"{res['K4']['checked_ms']:.4f} checked, "
          f"{res['K4']['device_ms']:.4f} ms "
          f"device; index_add_ {res['K4']['library_ms']:.4f} ms eager, "
          f"{res['K4']['library_device_ms']:.4f} ms device", flush=True)
    print(res["nvidia_smi"])
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
