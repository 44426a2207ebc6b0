#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one H100 and hold each of
its kernels against the plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each (plus detail lines):
  1. device: name, count, capability (must be 9.0), nvidia-smi name and
     power limit;
  2. build: nvcc of every kernel source under parsenet_tpu_torch/csrc;
  3. kernel vs plain on the card at main-path shapes:
     K1 mean-shift at 10,000 x 128, 50 iterations, the bandwidth of a
        stream-a embedding: f32 max |d| <= 1e-3 and the same NMS clustering
        (cluster numbering aside); bf16 co-membership >= 0.99;
     K2 auction on SIOU-structured and random 50 x 50 costs: identical
        assignments, every completed one a permutation;
     K3 min-sqdist at 10k x 10k and 204,800 x 2,500 (masked):
        |d| <= 1e-6 + 1e-5 |ref|, indices equal wherever the minimum is
        unique by more than 1e-5;
  4. slice: bench.py's stream "a" (seed 7, 2 warm-up + 8 timed batches of 4,
     10k points, bf16 mean-shift, spline_fit=None, shipped params) through
     parsenet_tpu_torch.eval.pipeline.run_batch; quality against the
     configs/quality_floors.json "bench" floors, shapes/hour, per-stage ms
     from CUDA events, and launches > 0 for K1, K2 and K3;
  5. kernel times at main-path shapes beside the plain version, the bound
     and, for K3, torch.cdist as a library yardstick.
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

# spline-free stream-a quality of the JAX package (artifacts/
# r5_infer_ablate.jsonl, arm "splines"), printed beside the port's
REFERENCE = {"seg_iou": 0.8907, "residual": 0.00907, "p_cov": 0.01523,
             "sk_2": 0.8899}

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
    from parsenet_tpu_torch.core.guards import entry_device
    from parsenet_tpu_torch.data.abc import normalize_points
    from parsenet_tpu_torch.data.synthetic import make_shape_batch
    from parsenet_tpu_torch.eval import pipeline as tp
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    from parsenet_tpu_torch.ops import hungarian as hg
    from parsenet_tpu_torch.ops import kernels
    from parsenet_tpu_torch.ops import mean_shift as ms
    from parsenet_tpu_torch.ops.segmentation import relaxed_iou, to_one_hot

    t_start = time.perf_counter()
    dev = entry_device("cuda")

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    cap = torch.cuda.get_device_capability(0)
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
    print(f"[2 build] {len(kernels.SOURCES)} kernels in {build_s:.2f} s",
          flush=True)
    for kname, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kname} ptxas: {line.strip()}")

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
    report = {"device": name, "nvidia_smi": smi, "build_s": build_s}

    # ---- 3. kernels against their plain versions
    def kernel_checks():
        print(f"[3 kernel vs plain] K1 bandwidth {float(bw):.6f}", flush=True)
        for bf16 in (False, True):
            k_out = kernels.mean_shift_iterations(embn, bw, 50, bf16_dots=bf16)
            p_out = kernels.mean_shift_iterations_plain(embn, bw, 50,
                                                        bf16_dots=bf16)
            k_lab = ms.nms(k_out, embn, bw)[1].cpu().numpy()
            p_lab = ms.nms(p_out, embn, bw)[1].cpu().numpy()
            err = float((k_out - p_out).abs().max())
            agree = co_membership(k_lab, p_lab)
            tag = "bf16" if bf16 else "f32"
            report[f"K1_{tag}_max_abs_err"] = err
            report[f"K1_{tag}_co_membership"] = agree
            if bf16:
                check(agree >= 0.99, f"K1 bf16 co-membership {agree:.6f} "
                      f">= 0.99 (max |d| {err:.3e}, clusters "
                      f"{k_lab.max() + 1}/{p_lab.max() + 1})")
            else:
                check(err <= 1e-3, f"K1 f32 max |d| {err:.3e} <= 1e-3")
                check(np.array_equal(canonical(k_lab), canonical(p_lab)),
                      f"K1 f32 NMS clustering identical ({k_lab.max() + 1} "
                      "clusters)")

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
            f"{k} {mean[k]:.5f}" + (f" (JAX spline-free {REFERENCE[k]})"
                                    if k in REFERENCE else "")
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
        for kname in kernels.SOURCES:
            check(launches[kname] > 0,
                  f"{kname} launched on the slice ({launches[kname]})")
        check(all(np.isfinite(v) for v in mean.values()),
              "slice metrics finite")

    phase(slice_run)

    # ---- 5. kernel times at main-path shapes
    entries = []

    def kernel_times():
        launches = report.get("slice", {}).get("launches", kernels.LAUNCHES)
        n, d, it = embn.shape[0], embn.shape[1], 50
        k1_bytes = 2 * n * d * 4
        k1_flops = it * 4 * n * n * d
        for bf16 in (False, True):
            k_ms = cuda_ms(lambda: kernels.mean_shift_iterations(
                embn, bw, it, bf16_dots=bf16), 3)
            p_ms = cuda_ms(lambda: kernels.mean_shift_iterations_plain(
                embn, bw, it, bf16_dots=bf16), 3)
            peak = PEAK_BF16 if bf16 else PEAK_FP32
            bound = 1000.0 * max(k1_flops / peak, k1_bytes / HBM_BYTES_S)
            tag = "bf16" if bf16 else "f32"
            print(f"[5 times] K1 {tag} 10000x128x50: kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms, bound {bound:.3f} ms (operations)",
                  flush=True)
            report[f"K1_{tag}_ms"] = (k_ms, p_ms, bound)
        k_ms, p_ms, bound = report["K1_bf16_ms"]  # the slice runs bf16
        entries.append({
            "name": "ms_iterations", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/ms_iterations.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:212",
            "launches": launches["K1"],
            "max_abs_err": report.get("K1_bf16_max_abs_err"),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": None})

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
        print(f"[5 times] K2 56x56 ({rounds} rounds to assign all): kernel "
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
            print(f"[5 times] K3 {nq}x{mx}: kernel {km:.4f} ms, plain "
                  f"{pm:.4f} ms, cdist {lm:.4f} ms, bound {b:.4f} ms "
                  "(operations)", flush=True)
            tot["ms"] += km
            tot["plain_ms"] += pm
            tot["library_ms"] += lm
            tot["bound"] += b
        entries.append({
            "name": "min_sqdist_idx", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/min_sqdist.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:418",
            "launches": launches["K3"], "max_abs_err": err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound"], "bound_by": "operations",
            "library_ms": tot["library_ms"]})

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
