#!/usr/bin/env python3
"""Does SplineNet training on the card repeat from run to run, and which
source makes it drift?

    python3 scripts/torch_spline_determinism.py [--root DIR] [--runs 2]
        [--settings base,gather,cudnn,all] [--out FILE]

Runs the open SplineNet trainer of `chip_smoke.py` phase 5 (full width,
36 patches, 3 + 20 steps through `train_spline.run_training` from seed 0,
then 2 validation batches) `--runs` times under each setting, with the
`parsenet_tpu_torch` of the checkout at DIR (default: this one), and
prints per setting each run's losses, the first step at which two runs
differ, the spread of the validation chamfer and ms/step. Settings:
  base    the trainer as it is;
  gather  the backward of `ops.knn.gather_neighbors` (an advanced-index
          gather, whose backward is an index_put_ that accumulates)
          computed under torch.use_deterministic_algorithms(True);
  cudnn   torch.backends.cudnn.deterministic = True (the Laplacian loss's
          grouped conv2d);
  all     both, and torch.use_deterministic_algorithms(True, warn_only=True)
          around the whole run.
K4 (min_sqdist_bwd.cu) is whatever the checkout's is: run this script on
two checkouts to compare their K4s. It also holds the checkout's K4
against its plain version at the training shape (dq and dx bitwise, where
the plain version sums in K4's order) and prints K4's device time from a
CUDA-graph replay. Needs one CUDA card.
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def det_gather(torch, knn_gather):
    """gather_neighbors whose backward runs under deterministic
    algorithms (set and restored around it)."""
    class Gather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, idx):
            ctx.save_for_backward(idx)
            ctx.shape = x.shape
            return knn_gather(x, idx)

        @staticmethod
        def backward(ctx, grad):
            (idx,) = ctx.saved_tensors
            b = torch.arange(ctx.shape[0], device=idx.device)[:, None, None]
            out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
            prev = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)
            try:
                out.index_put_((b.expand_as(idx), idx), grad, accumulate=True)
            finally:
                torch.use_deterministic_algorithms(prev)
            return out, None

    return lambda x, idx: Gather.apply(x, idx)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--settings", default="base,gather,cudnn,all")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_spline_determinism: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(1, HERE)
    import chip_smoke
    from parsenet_tpu_torch.core.config import Config
    from parsenet_tpu_torch.core.profiling import StageTimer
    from parsenet_tpu_torch.data.splines import synthetic_batches
    from parsenet_tpu_torch.ops import kernels, knn
    from parsenet_tpu_torch.train import train_spline as tsp

    dev = torch.device("cuda")
    result = {"root": root, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": chip_smoke.nvidia_smi_line(), "settings": {}}
    print(f"[determinism] {result['device']} ({result['nvidia_smi']}), "
          f"root {root}", flush=True)
    kernels.build_kernels()

    # K4 at the training shape against its plain version
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    b, n, m = 36, 700, 1600
    q = torch.rand(b, n, 3, device=dev, generator=gen)
    x = torch.rand(b, m, 3, device=dev, generator=gen)
    g = torch.rand(b, n, device=dev, generator=gen)
    idx = kernels.min_sqdist_with_idx(q, x)[1]
    dq_k, dx_k = kernels.min_sqdist_bwd(q, x, idx, g)
    dq_p, dx_p = kernels.min_sqdist_bwd_plain(q, x, idx, g)
    runs_same = all(torch.equal(dx_k, kernels.min_sqdist_bwd(q, x, idx, g)[1])
                    for _ in range(20))
    bwd = getattr(kernels, "_min_sqdist_bwd", kernels.min_sqdist_bwd)
    k4 = {"dq_bitwise": bool(torch.equal(dq_k, dq_p)),
          "dx_bitwise": bool(torch.equal(dx_k, dx_p)),
          "dx_max_abs_err": float((dx_k - dx_p).abs().max()),
          "dx_same_in_20_calls": bool(runs_same),
          "device_ms": chip_smoke.graph_ms(lambda: bwd(q, x, idx, g), 50)}
    result["K4"] = k4
    print(f"  K4 36 x (700 vs 1,600): {k4}", flush=True)

    gather0 = knn.gather_neighbors
    for setting in args.settings.split(","):
        knn.gather_neighbors = (det_gather(torch, gather0)
                                if setting in ("gather", "all") else gather0)
        torch.backends.cudnn.deterministic = setting in ("cudnn", "all")
        torch.use_deterministic_algorithms(setting == "all", warn_only=True)
        runs = []
        for _ in range(args.runs):
            gen_s = synthetic_batches(np.random.RandomState(10), 36, 700, 20,
                                      False)
            batches = [next(gen_s) for _ in range(25)]
            cfg = Config(model_path="determinism", batch_size=36,
                         grid_size=20, lr=1e-3, loss_weight=0.9,
                         num_epochs=1, seed=0,
                         log_dir=os.path.join(HERE, "chiprun_out",
                                              "determinism_logs"))
            timer = StageTimer(True)
            t0 = time.perf_counter()
            res = tsp.run_training(cfg, False, iter(batches[:-2]),
                                   iter(batches[-2:]), 23, val_steps=2,
                                   checkpoint=False, device=dev, timer=timer)
            timer.ms()
            ev = timer.events
            ms_step = ev["forward"][3][0].elapsed_time(
                ev["optimizer"][-1][1]) / 20
            runs.append({"losses": [s["loss"] for s in res.steps],
                         "val_cd": res.epochs[-1]["val_cd"],
                         "ms_per_step": ms_step,
                         "seconds": time.perf_counter() - t0})
        first = None
        for step in range(len(runs[0]["losses"])):
            if len({r["losses"][step] for r in runs}) > 1:
                first = step + 1
                break
        vals = [r["val_cd"] for r in runs]
        dloss = max(abs(a - b) for r in runs[1:]
                    for a, b in zip(runs[0]["losses"], r["losses"]))
        summary = {"first_differing_step": first, "val_cd": vals,
                   "val_cd_spread": max(vals) - min(vals),
                   "max_abs_dloss": dloss,
                   "ms_per_step": [r["ms_per_step"] for r in runs]}
        result["settings"][setting] = {"runs": runs, **summary}
        print(f"  {setting}: first differing step {first}, max |dloss| "
              f"{dloss:.3e}, val_cd {', '.join(f'{v:.9f}' for v in vals)}, "
              f"ms/step {', '.join(f'{r['ms_per_step']:.3f}' for r in runs)}",
              flush=True)
        for r in runs:
            print("    losses " + ", ".join(f"{v:.9g}" for v in r["losses"]))
    knn.gather_neighbors = gather0
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "settings"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
