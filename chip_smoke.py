#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one H100 and hold each of
its kernels against the plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each (plus detail lines):
  1. device: name, count, capability (must be 9.0), nvidia-smi name and
     power limit;
  2. build: nvcc of every kernel source under parsenet_tpu_torch/csrc;
     the ptxas lines (registers, spills, warnings) and the count of HGMMA
     (wgmma) instructions in the SASS of the tensor-core K1, which must be
     > 0;
  3. kernel vs plain on the card at main-path shapes:
     K1 mean-shift at 10,000 x 128, 50 iterations, the bandwidth of a
        stream-a embedding: f32 (FFMA kernel) max |d| <= 1e-3 and the same
        NMS clustering (cluster numbering aside); bf16 (tensor-core kernel)
        on ms_plan's grid (every SM, partial sums exchanged) and on one
        block per 128 rows (no exchange): max |d| <= 1e-4 after 1
        iteration and <= 1e-2 after 50, NMS co-membership >= 0.99; the
        same max |d| limits on both grids for clustered rows at N = 100,
        1,000 (D = 64) and 4,999 (f32 there too: <= 1e-3), and after 50
        iterations on each of 8 stream-a embeddings at its own bandwidth
        (co-membership >= 0.99, the minimum printed); 0 iterations give X
        back in both modes without a launch;
     K2 auction on SIOU-structured and random 50 x 50 costs: identical
        assignments, every completed one a permutation;
     K3 min-sqdist at 10k x 10k, 204,800 x 2,500 (masked) and, batched,
        36 x (700 vs 1,600), the SplineNet training shape:
        |d| <= 1e-6 + 1e-5 |ref|, indices equal wherever the minimum is
        unique by more than 1e-5;
     K4 min-sqdist backward at the training shape, on K3's argmins, for a
        random incoming gradient: dq and dx within 1e-5 + 1e-5 |ref| of
        gather + index_add_ (dx sums with float atomics, in no fixed
        order); and MinSqdist's gradients on the card are K4's, not zero;
     K5 one mean-shift step at 10,000 x 128, queries a perturbed copy of
        the stream-a embedding, keys the embedding: max |d| <= 1e-5;
  4. slice: bench.py's stream "a" (seed 7, 2 warm-up + 8 timed batches of 4,
     10k points, bf16 mean-shift, spline_fit=None, shipped params) through
     parsenet_tpu_torch.eval.pipeline.run_batch; quality against the
     configs/quality_floors.json "bench" floors, shapes/hour, per-stage ms
     from CUDA events, and launches > 0 for the tensor-core K1, K2 and
     K3, none for the FFMA K1 (the slice runs bf16);
  5. train: SplineNet at full width (grid 20, k 10, 36 patches of 700
     points, 40 x 40 surface samples, anisotropic, loss_weight 0.9, Adam
     at lr 1e-3):
     (a) parity: two train_steps from params/{open,closed}_splinenet.npz
         on a fixed synthetic batch; each step's loss, cd, l_reg and lap
         within 1e-3 (step 1) and 5e-3 (step 2, after the card's backward
         and Adam update) relative of the JAX package's
         (SPLINE_REFERENCE); the card's step-1 gradient of every tensor
         within 0.1 |ref| + 1e-8 of the plain path's on the CPU;
     (b) open, through train_spline.run_training from a seeded random
         init: 3 warm-up + 20 timed steps (448 or 700 points per step),
         ms/step, patches/s, per-stage ms from CUDA events; every loss
         finite, the last 5 below the first 5, K3 and K4 launched;
     (c) closed: 1 warm-up + 5 timed steps, the same checks but the
         falling loss;
     (d) each run's validation: eval_step's two-sided sqrt chamfer on 2
         batches;
  6. kernel times at main-path shapes beside the plain version, the bound
     and the library yardstick where PyTorch computes the same
     (sdpa_mean_shift for K1, torch.cdist for K3, index_add_ for K4's
     scatter); for K1 also the achieved TFLOP/s, the share of the bound,
     the floor the exponentials set on the MUFU units, the tensor-core
     launch alone, without the wrapper's tiling and allocations, and its
     two grids at 10,000 and 4,999 rows.
The last three lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}. Any failed check exits non-zero without the
ok line; without a CUDA device it exits 1 at once.
"""
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")
OUT_DIR = os.path.join(REPO, "chiprun_out")

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12
# ex2 per second on the MUFU units: 132 SMs x 16 a clock (compute
# capability 9.0) at 1.83 GHz, the clock at which 132 x 4,096 bf16 FLOP a
# clock make the 989 TFLOP/s above
MUFU_EX2_S = 132 * 16 * 1.83e9

# spline-free stream-a quality of the JAX package (artifacts/
# r5_infer_ablate.jsonl, arm "splines"), printed beside the port's
REFERENCE = {"seg_iou": 0.8907, "residual": 0.00907, "p_cov": 0.01523,
             "sk_2": 0.8899}
# the port's stream-a quality with the FFMA K1 (PERF.md, PR 2's runs)
PORT_FFMA_K1 = {"seg_iou": 0.89263, "residual": 0.00861, "sk_2": 0.88841}

# SplineNet training: full width, and the batch of each parity step:
# make_spline_batch(RandomState(seed), 36, 700, 20, closed), mean-centred
# and scaled per axis, without the PCA alignment (its rotation follows the
# sign of a LAPACK eigenvector, which differs between numpy builds) and
# without augmentation
GRID, SPLINE_BATCH, SPLINE_POINTS = 20, 36, 700
SPLINE_SEEDS = {"open": 0, "closed": 1}
# two train_steps of the JAX package (lr 1e-3, loss_weight 0.9) from
# params/{open,closed}_splinenet.npz on those batches, on the CPU:
# the output of `python scripts/spline_train_reference.py`
SPLINE_REFERENCE = {
    "open": [{"loss": 0.046678557991981506, "cd": 0.017725083976984024,
              "l_reg": 0.04824110120534897, "lap": 0.014890600927174091},
             {"loss": 0.07093440741300583, "cd": 0.01134300697594881,
              "l_reg": 0.06256694346666336, "lap": 0.13489852845668793}],
    "closed": [{"loss": 0.07450274378061295, "cd": 0.017208794131875038,
                "l_reg": 0.08086873590946198, "lap": 0.0},
               {"loss": 0.06250898540019989, "cd": 0.02108459174633026,
                "l_reg": 0.06711169332265854, "lap": 0.0}],
}
# Relative tolerance of each step's metrics. The second step's metrics
# follow the first step's gradients through Adam, whose first update moves
# every weight by lr times the sign of its gradient, whatever the size; so
# gradients that are round-off (the biases ahead of a BatchNorm) or that
# flip with a near-tied ReLU or kNN choice move the second step's metrics by
# up to 1.3e-3 between the port on the CPU and the JAX package.
PARITY_RTOL = (1e-3, 5e-3)
# The card's step-1 gradient of each tensor against the port's plain path on
# the CPU: |d| <= GRAD_RTOL |ref| + GRAD_ATOL. The port on the CPU and the
# JAX package differ by up to 2.5e-2 in one tensor (open conv6 kernel), for
# the same near-tied choices; GRAD_ATOL covers the round-off gradients
# (norms 1e-11 to 1e-9) of the biases ahead of a BatchNorm.
GRAD_RTOL, GRAD_ATOL = 0.1, 1e-8
# The tensor-core K1 against the plain bf16 version, max |d|: after one
# iteration only the order of the f32 sums and ex2.approx against exp
# differ; over 50 iterations those differences steer rows that sit between
# modes a little apart.
K1TC_TOL_1, K1TC_TOL_50 = 1e-4, 1e-2

FAILURES = []


def check(ok, what):
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)
    return ok


def phase(fn):
    """Run one phase; an exception is printed and fails the run."""
    try:
        return fn()
    except Exception:
        traceback.print_exc()
        FAILURES.append(f"{fn.__name__} raised")
        return None


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_count(lib, op):
    """Lines of `cuobjdump -sass lib` that hold the instruction `op`."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return sum(op in line for line in out.splitlines())


def cuda_ms(fn, reps):
    """Mean device ms of fn() over reps launches after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def canonical(labels):
    """Cluster ids renumbered by first appearance: equal iff same partition."""
    import numpy as np
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    rename = np.zeros(labels.max() + 1, np.int64)
    rename[labels[np.sort(first)]] = np.arange(first.size)
    return rename[labels]


def co_membership(a, b):
    """Fraction of point pairs on whose same-cluster relation a and b agree
    (Rand index), from the contingency table."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    n = a.size
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)
    pairs = lambda c: float((c * (c - 1) // 2).sum())
    both = pairs(table)
    only = pairs(table.sum(1)) + pairs(table.sum(0)) - 2 * both
    return 1.0 - only / (n * (n - 1) / 2)


def unique_min_mask(q, x, margin=1e-5, chunk=8192):
    """Queries whose second-nearest target is more than `margin` farther."""
    import torch
    out = []
    for s in range(0, q.shape[0], chunk):
        d = torch.cdist(q[s:s + chunk].double(), x.double()).pow(2)
        two = torch.topk(d, 2, dim=1, largest=False).values
        out.append(two[:, 1] - two[:, 0] > margin)
    return torch.cat(out)


def sdpa_mean_shift(X, bandwidth, iterations):
    """K1's library yardstick, timed beside it and used nowhere in the port:
    `iterations` steps of m <- normalize(softmax(2 inv2b2 m X^T) X), one
    F.scaled_dot_product_attention each, in X's dtype. The softmax's max
    shift cancels the kernel's constant factor exp(-2 inv2b2), so in f32
    this is kernels.mean_shift_iterations_plain up to round-off."""
    import torch
    import torch.nn.functional as F
    scale = 1.0 / float(bandwidth) ** 2      # 2 inv2b2
    x = X[None, None]
    m = x
    for _ in range(iterations):
        m = F.scaled_dot_product_attention(m, x, x, scale=scale)
        m = m / (torch.linalg.norm(m, dim=-1, keepdim=True) + 1e-12)
    return m[0, 0]


def clustered(rng, n, d, k=12, noise=0.08):
    """n unit rows of width d around k random unit centres."""
    import numpy as np
    c = rng.randn(k, d)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.randint(0, k, n)] + noise * rng.randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def rounds_to_assign(kernels, hg, benefit):
    """Fewest auction rounds after which the plain version has assigned
    every person (the work this input needs); the round cap if never."""
    def done(r):
        return bool((kernels.auction_assign_plain(
            benefit, hg._EPS0, hg._ESC_EVERY, hg._ESC, r) >= 0).all())
    lo, hi = 1, kernels.AUCTION_ROUNDS
    if not done(hi):
        return hi
    while lo < hi:   # once all are assigned, later rounds change nothing
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if done(mid) else (mid + 1, hi)
    return lo


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from parsenet_tpu_torch.core.config import Config
    from parsenet_tpu_torch.core.guards import entry_device
    from parsenet_tpu_torch.core.profiling import StageTimer
    from parsenet_tpu_torch.data.abc import normalize_points
    from parsenet_tpu_torch.data.splines import canon_batch, synthetic_batches
    from parsenet_tpu_torch.data.synthetic import (make_shape_batch,
                                                   make_spline_batch)
    from parsenet_tpu_torch.eval import pipeline as tp
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    from parsenet_tpu_torch.models.splinenet import load_splinenet
    from parsenet_tpu_torch.ops import hungarian as hg
    from parsenet_tpu_torch.ops import kernels
    from parsenet_tpu_torch.ops import mean_shift as ms
    from parsenet_tpu_torch.ops.bspline import (sample_surface,
                                                uniform_knot_bspline)
    from parsenet_tpu_torch.ops.segmentation import relaxed_iou, to_one_hot
    from parsenet_tpu_torch.train import train_spline as tsp
    from parsenet_tpu_torch.train.state import make_optimizer

    t_start = time.perf_counter()
    dev = entry_device("cuda")

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    cap = torch.cuda.get_device_capability(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = nvidia_smi_line()
    print(f"[1 device] {name} count={count} capability={cap[0]}.{cap[1]} "
          f"nvidia-smi: {smi} torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    if cap != (9, 0):
        print(f"chip_smoke: capability {cap} is not 9.0 (Hopper)",
              file=sys.stderr)
        return 1

    # ---- 2. build
    build_s = kernels.build_kernels()
    report = {"device": name, "nvidia_smi": smi, "build_s": build_s}
    print(f"[2 build] {len(kernels.SOURCES)} kernel sources in "
          f"{build_s:.2f} s", flush=True)
    for kname, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "arning")):
                print(f"  {kname} ptxas: {line.strip()}")

    def wgmma_in_sass():
        hgmma = sass_count(kernels._lib_path("K1tc"), "HGMMA")
        report["K1tc_hgmma"] = hgmma
        check(hgmma > 0, f"K1tc SASS holds {hgmma} HGMMA (wgmma) "
              "instructions")

    phase(wgmma_in_sass)

    # ---- shared inputs: stream a exactly as bench.py builds it
    n_batch, warmup, iters, n_pts = 4, 2, 8, 10000
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(7), (warmup + iters) * n_batch, n_pts)
    for i in range(pts.shape[0]):
        pts[i], normals[i], _, _ = normalize_points(pts[i], normals[i])
    pts, normals = pts.astype(np.float32), normals.astype(np.float32)
    model = load_primitives_embedding(PARAMS, mode=5, k=80, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        x0 = torch.from_numpy(np.concatenate([pts[:1], normals[:1]], -1))
        emb, logp0 = model(x0.to(dev))
    prim0 = torch.argmax(logp0[0], dim=-1)
    embn = (emb[0] / (torch.linalg.norm(emb[0], dim=-1, keepdim=True)
                      + 1e-12)).contiguous()
    bw = ms._initial_bandwidth(ms._subset_sqdist(embn, 5000, generator=gen),
                               0.015)

    # ---- shared training inputs: the parity batches, and surfaces at the
    # training shape (each open batch grid sampled 40 x 40, plus noise)
    nu, nv = (torch.from_numpy(a).to(dev)
              for a in uniform_knot_bspline(GRID, GRID, 3, 3, 40))
    spline_batches = {}
    for sname, seed in SPLINE_SEEDS.items():
        raw = make_spline_batch(np.random.RandomState(seed), SPLINE_BATCH,
                                SPLINE_POINTS, GRID, sname == "closed")
        spline_batches[sname] = tuple(torch.from_numpy(a).to(dev) for a in
                                      canon_batch(*raw, False, True)[:3])
    tq = spline_batches["open"][0]                          # [36, 700, 3]
    tx = sample_surface(nu, nv, spline_batches["open"][1])  # [36, 1600, 3]
    gen_k = torch.Generator(device=dev)   # the slice keeps `gen` to itself
    gen_k.manual_seed(2)
    tx = (tx + 0.01 * torch.randn(tx.shape, device=dev,
                                  generator=gen_k)).contiguous()
    g_k4 = torch.rand(tq.shape[:2], device=dev, generator=gen_k)
    # K5's queries: a perturbed copy of the stream-a embedding
    m5 = embn + 0.01 * torch.randn(embn.shape, device=dev, generator=gen_k)
    m5 = (m5 / torch.linalg.norm(m5, dim=1, keepdim=True)).contiguous()
    inv2b2 = 1.0 / (2.0 * bw * bw)

    # ---- 3. kernels against their plain versions
    def kernel_checks():
        print(f"[3 kernel vs plain] K1 bandwidth {float(bw):.6f}; K1tc "
              f"(grid, slots) {kernels.ms_plan(embn.shape[0], sms)}",
              flush=True)
        # K1 f32 (FFMA kernel)
        k_out = kernels.mean_shift_iterations(embn, bw, 50)
        p_out = kernels.mean_shift_iterations_plain(embn, bw, 50)
        k_lab = ms.nms(k_out, embn, bw)[1].cpu().numpy()
        p_lab = ms.nms(p_out, embn, bw)[1].cpu().numpy()
        err = float((k_out - p_out).abs().max())
        report["K1_f32_max_abs_err"] = err
        check(err <= 1e-3, f"K1 f32 max |d| {err:.3e} <= 1e-3")
        check(np.array_equal(canonical(k_lab), canonical(p_lab)),
              f"K1 f32 NMS clustering identical ({k_lab.max() + 1} "
              "clusters)")
        for bf16 in (False, True):   # no iteration: X back, no launch
            before = dict(kernels.LAUNCHES)
            same = bool(torch.equal(kernels.mean_shift_iterations(
                embn, bw, 0, bf16_dots=bf16), embn))
            check(same and kernels.LAUNCHES == before,
                  f"K1 {'bf16' if bf16 else 'f32'} 0 iterations: X back, "
                  "no launch")

        # K1 bf16 (tensor-core kernel) against the plain bf16 version, on
        # ms_plan's grid (every SM, partial sums exchanged) and on one block
        # per 128-row block (no exchange): max |d| after 1 iteration <=
        # K1TC_TOL_1, after 50 <= K1TC_TOL_50; NMS co-membership >= 0.99
        def k1tc(x, b, it, one_block):
            if not one_block:
                return kernels.mean_shift_iterations(x, b, it, bf16_dots=True)
            return kernels._ms_iterations_tc(
                x, kernels._inv2b2(b, dev), it,
                -(-x.shape[0] // kernels.MS_BLOCK_ROWS))[:, :x.shape[1]]

        def k1tc_checks(tag, x, b, one_block, its=(1, 50)):
            grid = "one block per 128 rows" if one_block else "ms_plan grid"
            errs = {}
            for it in its:
                k_out = k1tc(x, b, it, one_block)
                p_out = kernels.mean_shift_iterations_plain(x, b, it,
                                                            bf16_dots=True)
                errs[it] = float((k_out - p_out).abs().max())
                tol = K1TC_TOL_1 if it == 1 else K1TC_TOL_50
                check(errs[it] <= tol, f"K1tc bf16 {tag}, {grid}, {it} it: "
                      f"max |d| {errs[it]:.3e} <= {tol:g}")
            return errs, k_out, p_out

        x_tag = f"stream a {embn.shape[0]} x {embn.shape[1]}"
        for one_block in (False, True):
            errs, k_out, p_out = k1tc_checks(x_tag, embn, bw, one_block)
            k_lab = ms.nms(k_out, embn, bw)[1].cpu().numpy()
            p_lab = ms.nms(p_out, embn, bw)[1].cpu().numpy()
            agree = co_membership(k_lab, p_lab)
            key = "K1tc_one_block" if one_block else "K1_bf16"
            report[f"{key}_max_abs_err"] = errs[50]
            report[f"{key}_max_abs_err_1"] = errs[1]
            report[f"{key}_co_membership"] = agree
            check(agree >= 0.99, f"K1tc bf16 {x_tag}, "
                  f"{'one block per 128 rows' if one_block else 'ms_plan grid'}"
                  f": co-membership {agree:.6f} >= 0.99 (clusters "
                  f"{k_lab.max() + 1}/{p_lab.max() + 1})")

        # ragged N, D < 128, a single row block: clustered unit rows at
        # bandwidth 0.2, both grids; the f32 kernel at the same shapes
        rng_c = np.random.RandomState(0)
        for n_c, d_c in ((100, 128), (1000, 64), (4999, 128)):
            xc = torch.from_numpy(clustered(rng_c, n_c, d_c)).to(dev)
            for one_block in (False, True):
                k1tc_checks(f"clustered {n_c} x {d_c}", xc, 0.2, one_block)
            err = float((kernels.mean_shift_iterations(xc, 0.2, 50)
                         - kernels.mean_shift_iterations_plain(xc, 0.2, 50))
                        .abs().max())
            check(err <= 1e-3, f"K1 f32 clustered {n_c} x {d_c}, 50 it: "
                  f"max |d| {err:.3e} <= 1e-3")

        # the tensor-core K1 on 8 stream-a embeddings at their own bandwidth
        gen_e = torch.Generator(device=dev)   # leaves `gen` to the slice
        gen_e.manual_seed(3)
        agrees, errs, bf16_vs_f32 = [], [], []
        for i in range(8):
            with torch.no_grad():
                e = model(torch.from_numpy(np.concatenate(
                    [pts[i:i + 1], normals[i:i + 1]], -1)).to(dev))[0][0]
            e = (e / (torch.linalg.norm(e, dim=-1, keepdim=True)
                      + 1e-12)).contiguous()
            b = ms._initial_bandwidth(ms._subset_sqdist(e, 5000,
                                                        generator=gen_e),
                                      0.015)
            err, k_out, p_out = k1tc_checks(f"stream-a embedding {i}", e, b,
                                            False, its=(50,))
            p_lab = ms.nms(p_out, e, b)[1].cpu().numpy()
            errs.append(err[50])
            agrees.append(co_membership(ms.nms(k_out, e, b)[1].cpu().numpy(),
                                        p_lab))
            # the scale of NMS's own sensitivity: plain bf16 against f32
            f32_lab = ms.nms(kernels.mean_shift_iterations_plain(e, b, 50), e,
                             b)[1].cpu().numpy()
            bf16_vs_f32.append(co_membership(p_lab, f32_lab))
        report["K1tc_co_membership_8"] = agrees
        report["K1tc_max_abs_err_8"] = errs
        report["plain_bf16_vs_f32_co_membership_8"] = bf16_vs_f32
        print("  (plain bf16 against plain f32, co-membership: "
              + ", ".join(f"{v:.6f}" for v in bf16_vs_f32) + ")")
        check(min(agrees) >= 0.99, f"K1tc bf16 co-membership on 8 stream-a "
              f"embeddings: min {min(agrees):.6f} >= 0.99 (each: "
              + ", ".join(f"{v:.6f}" for v in agrees) + ")")

        rng = np.random.RandomState(0)
        costs = []
        for i in range(8):   # SIOU-structured: noisy predictions of GT
            gt = torch.from_numpy(labels[i].astype(np.int64)).to(dev)
            noise = torch.from_numpy(rng.rand(n_pts) < 0.1).to(dev)
            pred = torch.where(noise, torch.randint(
                0, 49, (n_pts,), device=dev, generator=gen),
                (gt * 7 + i) % 50)
            costs.append(1.0 - relaxed_iou(to_one_hot(pred), to_one_hot(gt)))
        costs += [torch.from_numpy(rng.rand(50, 50).astype(np.float32)).to(dev)
                  for _ in range(8)]
        benefit = hg.lap_benefit(torch.stack(costs))
        a_k = kernels.auction_assign(benefit, hg._EPS0, hg._ESC_EVERY,
                                     hg._ESC, 3000)
        a_p = kernels.auction_assign_plain(benefit, hg._EPS0, hg._ESC_EVERY,
                                           hg._ESC, 3000)
        same = bool(torch.equal(a_k, a_p))
        perms = all(sorted(hg.complete_assignment(a).tolist())
                    == list(range(50)) for a in a_k)
        report["K2_identical"] = same
        check(same, f"K2 assignments identical on {len(costs)} matrices "
              f"(8 SIOU-structured, 8 random; {int((a_k < 0).sum())} "
              "persons left for the rank fill)")
        check(perms, "K2 every completed assignment is a permutation")

        q = torch.from_numpy(pts[0]).to(dev)
        cases = [("10k x 10k", q, torch.from_numpy(pts[1]).to(dev), None)]
        surf = (torch.from_numpy(pts[2]).to(dev).repeat(21, 1)[:204800]
                + 0.01 * torch.randn(204800, 3, device=dev, generator=gen))
        mask = (torch.rand(2500, device=dev, generator=gen) < 0.8).float()
        cases.append(("204,800 x 2,500 masked", surf.contiguous(),
                      q[::4].contiguous(), mask))
        for tag, qq, xx, mk in cases:
            d_k, i_k = kernels.min_sqdist_with_idx(qq, xx, mk)
            d_p, i_p = kernels.min_sqdist_with_idx_plain(qq, xx, mk)
            err = (d_k - d_p).abs()
            ok = bool((err <= 1e-6 + 1e-5 * d_p.abs()).all())
            xs = xx if mk is None else xx[mk > 0]
            uniq = unique_min_mask(qq, xs)
            same_idx = bool((i_k == i_p)[uniq].all())
            report[f"K3_{tag}_max_abs_err"] = float(err.max())
            check(ok, f"K3 {tag}: max |d| {float(err.max()):.3e} within "
                  "1e-6 + 1e-5 |ref|")
            check(same_idx, f"K3 {tag}: indices equal on "
                  f"{int(uniq.sum())}/{uniq.numel()} unique minima")

        # K3 batched at the SplineNet training shape
        tag = f"batched {SPLINE_BATCH} x ({SPLINE_POINTS} vs {tx.shape[1]})"
        d_k, i_k = kernels.min_sqdist_with_idx(tq, tx)
        d_p, i_p = kernels.min_sqdist_with_idx_plain(tq, tx)
        err = (d_k - d_p).abs()
        uniq = torch.stack([unique_min_mask(tq[b], tx[b])
                            for b in range(SPLINE_BATCH)])
        report["K3_train_max_abs_err"] = float(err.max())
        check(bool((err <= 1e-6 + 1e-5 * d_p.abs()).all()),
              f"K3 {tag}: max |d| {float(err.max()):.3e} within "
              "1e-6 + 1e-5 |ref|")
        check(bool((i_k == i_p)[uniq].all()), f"K3 {tag}: indices equal on "
              f"{int(uniq.sum())}/{uniq.numel()} unique minima")

        # K4 on K3's argmins against gather + index_add_
        dq_k, dx_k = kernels.min_sqdist_bwd(tq, tx, i_k, g_k4)
        dq_p, dx_p = kernels.min_sqdist_bwd_plain(tq, tx, i_k, g_k4)
        err_q, err_x = (dq_k - dq_p).abs(), (dx_k - dx_p).abs()
        report["K4_max_abs_err"] = float(max(err_q.max(), err_x.max()))
        check(bool((err_q <= 1e-5 + 1e-5 * dq_p.abs())[uniq].all()),
              f"K4 dq: max |d| {float(err_q.max()):.3e} within 1e-5 + "
              f"1e-5 |ref| on {int(uniq.sum())} unique minima")
        check(bool((err_x <= 1e-5 + 1e-5 * dx_p.abs()).all()),
              f"K4 dx: max |d| {float(err_x.max()):.3e} within 1e-5 + "
              "1e-5 |ref| (float atomics)")
        qg, xg = tq.clone().requires_grad_(), tx.clone().requires_grad_()
        (kernels.MinSqdist.apply(qg, xg) * g_k4).sum().backward()
        check(bool(torch.equal(qg.grad, dq_k)) and float(qg.grad.abs().max())
              > 0 and bool(torch.allclose(xg.grad, dx_k, rtol=1e-5,
                                           atol=1e-5)),
              "MinSqdist gradients on the card are K4's and nonzero")

        # K5: one step of perturbed queries against the embedding
        err = float((kernels.mean_shift_step(m5, embn, inv2b2)
                     - kernels.mean_shift_step_plain(m5, embn, inv2b2))
                    .abs().max())
        report["K5_max_abs_err"] = err
        check(err <= 1e-5, f"K5 10,000 x 128 step, m != x: max |d| "
              f"{err:.3e} <= 1e-5")

    phase(kernel_checks)

    # ---- 4. the slice
    def slice_run():
        floors = json.load(open(os.path.join(REPO, "configs",
                                             "quality_floors.json")))["bench"]
        kernels.reset_launches()
        batches = [slice(b * n_batch, (b + 1) * n_batch)
                   for b in range(warmup + iters)]
        for s in batches[:warmup]:
            tp.run_batch(model, pts[s], normals[s], labels[s], prim[s], gen,
                         ms_bf16=True, device=dev)
        timer = tp.StageTimer(True)
        metrics = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in batches[warmup:]:
            m = tp.run_batch(model, pts[s], normals[s], labels[s], prim[s],
                             gen, ms_bf16=True, device=dev, timer=timer)
            for k, v in m.items():
                metrics.setdefault(k, []).extend(v)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n_shapes = iters * n_batch
        mean = {k: float(np.mean(v)) for k, v in metrics.items()}
        stage = {k: v / n_shapes for k, v in timer.ms().items()}
        report["slice"] = {"metrics": mean, "per_shape": metrics,
                           "shapes_per_hour": n_shapes / dt * 3600.0,
                           "ms_per_shape": 1000.0 * dt / n_shapes,
                           "stage_ms_per_shape": stage,
                           "launches": launches}
        print(f"[4 slice] {n_shapes} timed shapes: "
              f"{n_shapes / dt * 3600.0:.1f} shapes/hour, "
              f"{1000.0 * dt / n_shapes:.2f} ms/shape", flush=True)
        print("  quality: " + ", ".join(
            f"{k} {mean[k]:.5f}" + (f" (JAX spline-free {REFERENCE[k]}"
                                    if k in REFERENCE else "")
            + (f", FFMA K1 {PORT_FFMA_K1[k]}" if k in PORT_FFMA_K1 else "")
            + (")" if k in REFERENCE else "")
            for k in ("seg_iou", "prim_iou", "residual", "p_cov", "sk_2")))
        print(f"  clusters per shape: mean {mean['num_clusters']:.2f}, max "
              f"{max(metrics['num_clusters'])}")
        print("  stage ms/shape: " + ", ".join(
            f"{k} {stage.get(k, 0.0):.3f}" for k in tp.STAGES))
        print(f"  launches (10 batches): {launches}")
        check(mean["seg_iou"] >= floors["seg_iou_min"],
              f"seg_iou {mean['seg_iou']:.4f} >= {floors['seg_iou_min']}")
        check(mean["residual"] <= floors["residual_max"],
              f"residual {mean['residual']:.5f} <= {floors['residual_max']}")
        check(mean["sk_2"] >= floors["sk_2_min"],
              f"sk_2 {mean['sk_2']:.4f} >= {floors['sk_2_min']}")
        for kname in ("K1tc", "K2", "K3"):
            check(launches[kname] > 0,
                  f"{kname} launched on the slice ({launches[kname]})")
        check(launches["K1"] == 0, f"the FFMA K1 not launched on the slice "
              f"({launches['K1']})")
        check(all(np.isfinite(v) for v in mean.values()),
              "slice metrics finite")

    phase(slice_run)

    # ---- 5. SplineNet training
    def train_run():
        out = report["train"] = {"launches": {k: 0 for k in kernels.LAUNCHES}}
        # (a) parity with the JAX package from the shipped weights, over two
        # steps; between them, the card's gradients against the plain
        # path's on the CPU from the same weights and batch
        cpu = torch.device("cpu")
        for sname, ref in SPLINE_REFERENCE.items():
            closed = sname == "closed"
            models, steps = {}, {}
            for where in (dev, cpu):
                models[where] = load_splinenet(
                    os.path.join(REPO, "params", f"{sname}_splinenet.npz"),
                    int(closed), GRID, device=where)
                steps[where] = tsp.make_train_step(
                    models[where], make_optimizer(models[where].parameters()),
                    nu.to(where), nv.to(where), GRID, closed, True)[0]
            batch = spline_batches[sname]
            got = [steps[dev](*batch, 1e-3, 0.9)]
            steps[cpu](*(t.cpu() for t in batch), 1e-3, 0.9)
            grad_err = {}
            for (pname, p), q in zip(models[dev].named_parameters(),
                                     models[cpu].parameters()):
                diff = float(torch.linalg.norm(p.grad.cpu() - q.grad))
                grad_err[pname] = (diff, float(torch.linalg.norm(q.grad)))
            got.append(steps[dev](*batch, 1e-3, 0.9))
            got = [{k: float(v) for k, v in g.items()} for g in got]
            out[f"parity_{sname}"] = {"steps": got, "grad_err": grad_err}
            for i, (g, r) in enumerate(zip(got, ref)):
                print(f"[5 train] (a) {sname} step {i + 1} from the shipped "
                      "weights: " + ", ".join(f"{k} {g[k]:.9g} (JAX {v:.9g})"
                                              for k, v in r.items()),
                      flush=True)
                tol = PARITY_RTOL[i]
                for k, v in r.items():
                    rel = abs(g[k] - v) / abs(v) if v else abs(g[k])
                    check(rel <= tol, f"{sname} step {i + 1} {k} within "
                          f"{tol:g} relative of JAX ({rel:.2e})")
            worst = max(grad_err, key=lambda n: grad_err[n][0]
                        / (grad_err[n][1] + GRAD_ATOL))
            rel = sorted(((d / max(r, 1e-30), n, r)
                          for n, (d, r) in grad_err.items()), reverse=True)
            print(f"  {sname} step 1 gradients, card vs CPU plain path, "
                  "largest |d| / |ref|: " + ", ".join(
                      f"{n} {e:.2e} (|ref| {r:.2e})" for e, n, r in rel[:6]),
                  flush=True)
            check(all(d <= GRAD_RTOL * r + GRAD_ATOL
                      for d, r in grad_err.values()),
                  f"{sname} gradients of all {len(grad_err)} tensors within "
                  f"{GRAD_RTOL:g} |ref| + {GRAD_ATOL:g} of the CPU's (worst "
                  f"{worst}: {grad_err[worst][0]:.3e} of "
                  f"{grad_err[worst][1]:.3e})")
        # (b) open and (c) closed through run_training, (d) their validation
        for sname, warm, timed in (("open", 3, 20), ("closed", 1, 5)):
            closed = sname == "closed"
            gen_s = synthetic_batches(np.random.RandomState(10 + closed),
                                      SPLINE_BATCH, SPLINE_POINTS, GRID,
                                      closed)
            batches = [next(gen_s) for _ in range(warm + timed + 2)]
            cfg = Config(model_path=f"chip_smoke_{sname}",
                         batch_size=SPLINE_BATCH, grid_size=GRID, lr=1e-3,
                         loss_weight=0.9, num_epochs=1, seed=0,
                         log_dir=os.path.join(OUT_DIR, "train_logs"))
            timer = StageTimer(True)
            kernels.reset_launches()
            res = tsp.run_training(cfg, closed, iter(batches[:-2]),
                                   iter(batches[-2:]), warm + timed,
                                   val_steps=2, checkpoint=False,
                                   device=dev, timer=timer)
            launches = dict(kernels.LAUNCHES)
            timer.ms()   # synchronises
            ev = timer.events
            ms_step = ev["knn_forward"][warm][0].elapsed_time(
                ev["optimizer"][-1][1]) / timed
            stage = {k: sum(a.elapsed_time(b) for a, b in ev[k][warm:])
                     / timed for k in tsp.STAGES}
            losses = [st["loss"] for st in res.steps]
            val_cd = res.epochs[-1]["val_cd"]
            for k in launches:
                out["launches"][k] += launches[k]
            out[sname] = {"ms_per_step": ms_step,
                          "patches_per_s": SPLINE_BATCH * 1000.0 / ms_step,
                          "stage_ms_per_step": stage, "losses": losses,
                          "val_cd": val_cd, "launches": launches,
                          "warmup_steps": warm, "timed_steps": timed}
            print(f"[5 train] ({'b' if not closed else 'c'}) {sname}: "
                  f"{timed} timed steps, {ms_step:.3f} ms/step, "
                  f"{SPLINE_BATCH * 1000.0 / ms_step:.1f} patches/s; stage "
                  "ms/step: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in stage.items()),
                  flush=True)
            print(f"  losses: {', '.join(f'{v:.5f}' for v in losses)}")
            print(f"  (d) validation chamfer (sqrt, two-sided, 2 batches): "
                  f"{val_cd:.6f}; launches {launches}", flush=True)
            check(all(np.isfinite(v) for v in losses) and np.isfinite(val_cd),
                  f"{sname} losses and validation chamfer finite")
            if not closed:
                first, last = np.mean(losses[:5]), np.mean(losses[-5:])
                check(last < first, f"open loss falls: mean of the last 5 "
                      f"{last:.5f} < first 5 {first:.5f}")
            check(launches["K3"] > 0 and launches["K4"] > 0,
                  f"{sname} training launched K3 and K4 ({launches})")

    phase(train_run)

    # ---- 6. kernel times at main-path shapes
    entries = []

    def kernel_times():
        launches = report.get("slice", {}).get("launches", kernels.LAUNCHES)
        n, d, it = embn.shape[0], embn.shape[1], 50
        k1_bytes = 2 * n * d * 4
        k1_flops = it * 4 * n * n * d
        mufu_ms = 1000.0 * it * n * n / MUFU_EX2_S
        bw_f = float(bw)
        for bf16 in (False, True):
            k_ms = cuda_ms(lambda: kernels.mean_shift_iterations(
                embn, bw, it, bf16_dots=bf16), 10 if bf16 else 3)
            p_ms = cuda_ms(lambda: kernels.mean_shift_iterations_plain(
                embn, bw, it, bf16_dots=bf16), 3)
            xs = embn.to(torch.bfloat16) if bf16 else embn
            l_ms = cuda_ms(lambda: sdpa_mean_shift(xs, bw_f, it), 3)
            peak = PEAK_BF16 if bf16 else PEAK_FP32
            bound = 1000.0 * max(k1_flops / peak, k1_bytes / HBM_BYTES_S)
            tag = "bf16" if bf16 else "f32"
            print(f"[6 times] K1 {tag} ({'tensor cores' if bf16 else 'FFMA'})"
                  f" 10000x128x50: kernel {k_ms:.3f} ms "
                  f"({k1_flops / k_ms / 1e9:.1f} TFLOP/s, "
                  f"{100.0 * bound / k_ms:.1f}% of the bound), plain "
                  f"{p_ms:.3f} ms, SDPA yardstick {l_ms:.3f} ms, bound "
                  f"{bound:.3f} ms (operations)"
                  + (f", exp floor on the MUFU units {mufu_ms:.3f} ms"
                     if bf16 else ""), flush=True)
            report[f"K1_{tag}_ms"] = (k_ms, p_ms, bound, l_ms)
        # the tensor-core launch alone, without the wrapper's tiling and
        # allocations (the counters zeroed as the wrapper does)
        grid, slots = kernels.ms_plan(n, sms)
        blocks = -(-n // kernels.MS_BLOCK_ROWS)
        xt = kernels.ms_tiles_bf16(embn)
        out = torch.empty((n, kernels.MS_WIDTH), device=dev)
        ws = torch.empty(2 * blocks * slots * kernels.MS_PART_FLOATS,
                         device=dev)
        counters = torch.zeros(blocks, dtype=torch.int32, device=dev)
        inv = kernels._inv2b2(bw, dev)
        bare_ms = cuda_ms(lambda: (counters.zero_(), kernels._launch(
            "K1tc", xt.data_ptr(), out.data_ptr(), inv.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), n, it, grid, slots)), 10)
        report["K1tc_launch_alone_ms"] = bare_ms
        print(f"  K1 bf16 launch alone (pre-tiled, grid {grid}, slots "
              f"{slots}): {bare_ms:.3f} ms", flush=True)
        # the tensor-core K1's two grids at 10,000 and 4,999 stream-a rows,
        # and the 10,000 rows at bandwidth 0.2 (ms_plan's grid)
        grids = {}
        for rows in (n, 4999):
            x_r = embn[:rows].contiguous()
            for g in (kernels.ms_plan(rows, sms)[0],
                      -(-rows // kernels.MS_BLOCK_ROWS)):
                grids[f"{rows} rows, grid {g}"] = cuda_ms(
                    lambda: kernels._ms_iterations_tc(x_r, inv, it, g), 10)
        inv_02 = kernels._inv2b2(0.2, dev)
        grids[f"{n} rows, grid {grid}, bandwidth 0.2"] = cuda_ms(
            lambda: kernels._ms_iterations_tc(embn, inv_02, it, grid), 10)
        report["K1tc_grid_ms"] = grids
        print("  K1 bf16 through _ms_iterations_tc: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in grids.items()), flush=True)
        for tag, kname, src in (
                ("f32", "K1", "ms_iterations"),
                ("bf16", "K1tc", "ms_iterations_tc")):
            k_ms, p_ms, bound, l_ms = report[f"K1_{tag}_ms"]
            entries.append({
                "name": src, "route": "cuda",
                "source": f"parsenet_tpu_torch/csrc/{src}.cu",
                "replaces": "parsenet_tpu/ops/pallas_kernels.py:212",
                "launches": launches[kname],
                "max_abs_err": report.get(f"K1_{tag}_max_abs_err"),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": "operations", "library_ms": l_ms})

        # K2 on a main-path SIOU matrix (shape 0's f32 clustering vs GT)
        lab0 = ms.nms(kernels.mean_shift_iterations(embn, bw, it), embn,
                      bw)[1]
        gt0 = torch.from_numpy(labels[0].astype(np.int64)).to(dev)
        ben = hg.lap_benefit(1.0 - relaxed_iou(to_one_hot(lab0),
                                               to_one_hot(gt0)))
        rounds = rounds_to_assign(kernels, hg, ben)
        n_pad = 56
        k2_ops = rounds * 4 * n_pad * n_pad
        k2_bytes = n_pad * n_pad * 4 + n_pad * 4
        a_k = kernels.auction_assign(ben, hg._EPS0, hg._ESC_EVERY, hg._ESC,
                                     3000)
        a_p = kernels.auction_assign_plain(ben, hg._EPS0, hg._ESC_EVERY,
                                           hg._ESC, 3000)
        k_ms = cuda_ms(lambda: kernels.auction_assign(
            ben, hg._EPS0, hg._ESC_EVERY, hg._ESC, 3000), 20)
        p_ms = cuda_ms(lambda: kernels.auction_assign_plain(
            ben, hg._EPS0, hg._ESC_EVERY, hg._ESC, 3000), 5)
        bound = 1000.0 * max(k2_ops / PEAK_FP32, k2_bytes / HBM_BYTES_S)
        print(f"[6 times] K2 56x56 ({rounds} rounds to assign all): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bound:.6f} ms "
              f"({'operations' if k2_ops / PEAK_FP32 > k2_bytes / HBM_BYTES_S else 'bytes'})",
              flush=True)
        entries.append({
            "name": "auction_assign", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/auction_assign.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:345",
            "launches": launches["K2"],
            "max_abs_err": float((a_k - a_p).abs().max()),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": ("operations" if k2_ops / PEAK_FP32
                         > k2_bytes / HBM_BYTES_S else "bytes"),
            "library_ms": None})

        # K3: one shape's three calls (trim, points->samples, samples->points)
        p0 = torch.from_numpy(pts[0]).to(dev)
        rec = tp.reconstruct_shape(p0, torch.from_numpy(normals[0]).to(dev),
                                   lab0, prim0,
                                   generator=gen, device=dev)
        flat = rec.surface_points.reshape(-1, 3).contiguous()
        samp = flat[torch.randint(0, flat.shape[0], (10000,), device=dev,
                                  generator=gen)].contiguous()
        calls = [(flat, p0[::4].contiguous()), (p0, samp), (samp, p0)]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound": 0.0}
        err = 0.0
        for qq, xx in calls:
            nq, mx = qq.shape[0], xx.shape[0]
            b = 1000.0 * max(8 * nq * mx / PEAK_FP32,
                             ((nq + mx) * 3 * 4 + nq * 8) / HBM_BYTES_S)
            km = cuda_ms(lambda: kernels.min_sqdist_with_idx(qq, xx), 10)
            pm = cuda_ms(lambda: kernels.min_sqdist_with_idx_plain(qq, xx), 3)
            lm = cuda_ms(lambda: torch.cdist(qq, xx).pow(2).min(1), 3)
            err = max(err, float((kernels.min_sqdist_with_idx(qq, xx)[0]
                                  - kernels.min_sqdist_with_idx_plain(
                                      qq, xx)[0]).abs().max()))
            print(f"[6 times] K3 {nq}x{mx}: kernel {km:.4f} ms, plain "
                  f"{pm:.4f} ms, cdist {lm:.4f} ms, bound {b:.4f} ms "
                  "(operations)", flush=True)
            tot["ms"] += km
            tot["plain_ms"] += pm
            tot["library_ms"] += lm
            tot["bound"] += b
        # K3 batched at the training shape: one launch per train step
        train_l = report.get("train", {}).get(
            "launches", {k: 0 for k in kernels.LAUNCHES})
        bq, nq, mx = tq.shape[0], tq.shape[1], tx.shape[1]
        t_bound = 1000.0 * max(8 * bq * nq * mx / PEAK_FP32,
                               bq * ((nq + mx) * 12 + nq * 8) / HBM_BYTES_S)
        t_ms = cuda_ms(lambda: kernels.min_sqdist_with_idx(tq, tx), 50)
        t_plain = cuda_ms(lambda: kernels.min_sqdist_with_idx_plain(tq, tx),
                          10)
        t_lib = cuda_ms(lambda: torch.cdist(tq, tx).pow(2).min(2), 10)
        print(f"[6 times] K3 batched {bq}x({nq} vs {mx}): kernel "
              f"{t_ms:.4f} ms, plain {t_plain:.4f} ms, cdist {t_lib:.4f} ms, "
              f"bound {t_bound:.5f} ms (operations)", flush=True)
        entries.append({
            "name": "min_sqdist_idx", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/min_sqdist.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:418",
            "launches": launches["K3"] + train_l["K3"],
            "max_abs_err": max(err, report.get("K3_train_max_abs_err", 0.0)),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound"], "bound_by": "operations",
            "library_ms": tot["library_ms"],
            "launches_inference": launches["K3"],
            "launches_train": train_l["K3"],
            "train_ms": t_ms, "train_plain_ms": t_plain,
            "train_bound_ms": t_bound, "train_library_ms": t_lib})

        # K4 at the training shape, on K3's argmins
        idx = kernels.min_sqdist_with_idx(tq, tx)[1]
        rows = (idx.long() + mx * torch.arange(bq, device=dev)[:, None]
                ).reshape(-1)
        # q, idx, g read and dq written per query; each distinct argmin row
        # of x read once; dx written once
        n_rows = int(torch.unique(rows).numel())
        k4_bytes = bq * nq * (12 + 4 + 4 + 12) + n_rows * 12 + bq * mx * 12
        k4_bound = 1000.0 * max(bq * nq * 12 / PEAK_FP32,
                                k4_bytes / HBM_BYTES_S)
        dq_p, dx_p = kernels.min_sqdist_bwd_plain(tq, tx, idx, g_k4)
        dx_lib = torch.zeros((bq * mx, 3), device=dev)
        k4_ms = cuda_ms(lambda: kernels.min_sqdist_bwd(tq, tx, idx, g_k4), 50)
        k4_plain = cuda_ms(lambda: kernels.min_sqdist_bwd_plain(
            tq, tx, idx, g_k4), 20)
        k4_lib = cuda_ms(lambda: dx_lib.index_add_(
            0, rows, dq_p.reshape(-1, 3), alpha=-1.0), 20)
        print(f"[6 times] K4 {bq}x({nq} vs {mx}): kernel {k4_ms:.4f} ms, "
              f"plain {k4_plain:.4f} ms, index_add_ {k4_lib:.4f} ms, bound "
              f"{k4_bound:.5f} ms (bytes: {k4_bytes} bytes, {n_rows} "
              "distinct argmin rows)", flush=True)
        entries.append({
            "name": "min_sqdist_bwd", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/min_sqdist_bwd.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:463",
            "launches": train_l["K4"],
            "max_abs_err": report.get("K4_max_abs_err"),
            "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
            "bound_by": "bytes", "library_ms": k4_lib})

        # K5: one step at 10,000 x 128 (no program path runs it)
        k5_bound = 1000.0 * max(4 * n * n * d / PEAK_FP32,
                                3 * n * d * 4 / HBM_BYTES_S)
        k5_ms = cuda_ms(lambda: kernels.mean_shift_step(m5, embn, inv2b2), 5)
        k5_plain = cuda_ms(lambda: kernels.mean_shift_step_plain(
            m5, embn, inv2b2), 5)
        print(f"[6 times] K5 10000x128 one step: kernel {k5_ms:.3f} ms, "
              f"plain {k5_plain:.3f} ms, bound {k5_bound:.3f} ms "
              "(operations)", flush=True)
        entries.append({
            "name": "ms_step", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/ms_iterations.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:83",
            "launches": launches["K5"] + train_l["K5"],
            "max_abs_err": report.get("K5_max_abs_err"),
            "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
            "bound_by": "operations", "library_ms": None})

    phase(kernel_times)
    report["kernels"] = entries
    report["failures"] = FAILURES
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"chip_smoke: {report['seconds']:.1f} s, "
          f"{len(FAILURES)} failed checks", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    if FAILURES:
        print("chip_smoke: FAILED: " + "; ".join(FAILURES), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
