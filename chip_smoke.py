#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one H100 and hold each of
its kernels against the plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each (plus detail lines):
  1. device: name, count, capability (must be 9.0), nvidia-smi name and
     power limit;
  2. build: nvcc of every kernel source under parsenet_tpu_torch/csrc;
     the ptxas lines (registers, spills, warnings: no spill and no
     C751x "wgmma serialized" note in either K1 library), the count of
     HGMMA (wgmma) instructions in the SASS of each instantiation of both
     tensor-core K1s (bf16 and 3xTF32): the fixed-count ones must keep
     their 24 and 60, the early-exit ones must have some, and the
     instructions of K3's scan loop for each R, per (target, query) pair;
  3. kernel vs plain on the card at main-path shapes:
     K1 f32 (3xTF32 tensor-core kernel) at the 10,000 x 128 stream-a
        embedding and its bandwidth, on ms_plan's grid (every SM, partial
        sums exchanged) and on one block per 128 rows (no exchange): max
        |d| from the plain f32 version <= 1e-5 after 1 iteration and <= 1e-3
        after 50, the same NMS clustering (cluster numbering aside); at
        the e2e trainer's escalation attempts, its first 8,000 rows for 5
        iterations at its bandwidth and at the e2e loss's (quantile 0.025
        of 2,048 rows), max |d| <= 1e-5 after 1 and <= 1e-3 after 5, and
        the same NMS clustering; the
        same max |d| limits on both grids for clustered rows at N = 100,
        1,000 (D = 64) and 4,999; after 50 iterations on each of 8 stream-a
        embeddings at its own bandwidth, NMS co-membership >= 0.999, or,
        where plain f32 with the keys reordered already moves NMS more,
        >= the reordered version's;
     K1 bf16 (tensor-core kernel) on both grids: max |d| from the plain
        bf16 version <= 1e-4 after 1 iteration and <= 1e-2 after 50, NMS
        co-membership >= 0.99; the same limits for the clustered rows and
        the 8 stream-a embeddings (co-membership >= 0.99, the minimum
        printed, beside plain bf16 against plain f32); 0 iterations give X
        back in both modes without a launch;
     K2, both entries (lap_assign: the whole solve_lap, cost to
        permutation; auction_assign: the auction on a benefit), each in one
        batched call, on 8 SIOU-structured and 8 random 50 x 50 costs, on
        4 tied matrices (costs in quarters) at n = 1, 8, 33 and 64, and on
        the random ones capped at 5 rounds (persons left to the rank
        fill): identical to the plain versions, every completed assignment
        a permutation;
     K3 min-sqdist at 10k x 10k, 204,800 x 2,500 (masked) and, batched,
        36 x (700 vs 1,600), the SplineNet training shape:
        |d| <= 1e-6 + 1e-5 |ref|, indices equal wherever the minimum is
        unique by more than 1e-5; on exact ties (integer coordinates,
        every target twice, shuffled) at 10,000 x 10,000, 204,800 x 2,500
        and 36 x (700 vs 1,600): d and indices equal everywhere; at ragged
        sizes (N, M of 1, 63, 65, 1,601), masked, the same limits, and in a
        batch with one fully masked patch, 1e30 and index 0 there;
     K4 min-sqdist backward, on K3's argmins, for a random incoming
        gradient, at the training shape and at 2 x (30,000 vs 40,000) (more
        than one shared-memory chunk a patch, query entries in device
        memory): dq and dx bitwise equal to the plain version (dx summed in
        ascending query order, as the kernel sums it), and the same bits in
        a second call; MinSqdist's gradients on the card are K4's, not
        zero;
     K5 one mean-shift step (the 3xTF32 kernel, one iteration, queries
        apart from keys) at 10,000 x 128, queries a perturbed copy of the
        stream-a embedding, keys the embedding, and at 300 queries vs 1,000
        keys and 1,000 vs 300 (D = 64), on both grids: max |d| <= 1e-5;
     K1 exit (tol 1e-6 and 1e-3, 50 iterations), both modes, on every SM
        and on a 33-block grid, at the stream-a embedding and the clustered
        rows (N = 100 to 20,000, more row blocks than SMs included; D = 64
        and 128): two launches equal bit for bit; the iterations each
        128-row block ran (the kernels' output) must be those the rule
        gives on the kernel's own trajectory (the same launch capped at 1,
        2, ... iterations), and its m that iteration's, exactly; in bf16
        its first iteration the fixed-count kernel's bit for bit where both
        split the work alike; the iterations equal to the plain version's
        at exit_rows = 128 but where both deltas at the first disputed
        iteration lie within 2.5e-7 (f32, one iteration apart at most) or
        1e-4 (bf16) of tol; max |d| from the plain version within the
        50-iteration limits above (1e-3 f32, 1e-2 bf16), and at tol 1e-6
        from the kernel's own tol = 0 run within 1e-4 (f32) and 1e-2
        (bf16), while at 1e-3 the exit must move m by more than those
        limits somewhere; each of these launches runs under a watchdog, and
        one that does not return within 60 s fails the run (a hung
        exchange); with nothing leaving, the bf16 exit's iterations 1-5
        the fixed-count kernel's bit for bit, and the f32 exit's m after
        one iteration on every SM, 33 and 8 blocks within 2.5e-7 of each
        other (its chains of 32 tiles; beside it, the spread of the
        fixed-count kernel's one step over 1 to 39 sharers, and at noise
        0.08 the 20,000 rows' distance from plain, readings);
  3b. K3 and K4 at the e2e loss's shapes: the 4 spline slots' chamfer,
     8,000 points of a stream-a shape against 900 surface samples a slot,
     and its masked reverse with slot 3's GT segment empty (every target
     masked): K3 within the limits above, 1e30 and index 0 on the masked
     slot; K4 on those argmins with a random incoming gradient and, on
     the slot chamfer, with the loss's (mean over the GT segment's points,
     0 on the others), dq and dx bitwise equal to the plain version and
     finite (the masked slot too);
  4. slice: bench.py's stream "a" (seed 7, 2 warm-up + 8 timed batches of 4,
     10k points, bf16 mean-shift, the spline slots from the shipped
     params/{open,closed}_splinenet.npz, shipped params) through
     parsenet_tpu_torch.eval.pipeline.run_batch; quality against the
     configs/quality_floors.json "bench" floors, printed beside the JAX
     package's full-path figures (BENCH_r05.json), shapes/hour, per-stage ms
     from CUDA events, and launches > 0 for the bf16 K1 and K2, 4 of K3 a
     shape (the slot residual one of them), one of K2 a batch (10: one SIOU
     call a batch), none for the f32 K1; on the first timed batch's 4 SIOU
     matrices both K2 entries in one call against their plain versions,
     and its batched SIOU against the one-shape calls, bitwise; the
     coverage cdf of the first timed shape's trimmed area weights built 20
     times with a 1-d torch.cumsum and with fixed_order_cdf (the one
     protocol_coverage takes), the distinct results of each counted (the
     latter must give one); stream a once more from the same generator
     state, every per-shape metric (p_cov, sk_1, sk_2 included) equal bit
     for bit; then the spline-free path (spline_fit=None), 2 timed
     batches, beside the JAX package's figures of that path;
  4b. the library's default f32 mean-shift: the first timed batch of
     stream a through run_batch(..., ms_bf16=False) and, beside it, with
     ms_bf16=True (the second of two runs each, one generator seed): ms a
     shape and the quality metrics of both; the f32 run must launch the
     3xTF32 K1 and not the bf16 one;
  4c. the early-exit path: guard_mean_shift(..., tol=1e-6) (quantile
     0.015, 50 iterations, 5,000-point subset, as
     scripts/torch_ab_mean_shift.py) on the first timed batch's 4
     embeddings in both modes: both exit kernels launched, labels against
     the tol = 0 guard's (co-membership >= 0.99), ms a shape;
  4d. the test protocol: the port's CLIs (parsenet_tpu_torch.cli) at full
     width on 8 shapes of stream a (shapes 8-15, 10k points), mode 5, k 80,
     params/parsenet_e2e.npz placed as {log_dir}/checkpoints/
     {model_path}.npz of a temporary config under OUT_DIR (removed
     after): generate_predictions on 2 batches of 4 (f32 mean-shift), test
     on the 8 shapes with the 12 spline slots, test --optimize on 2 of them,
     test_open_splines and test_closed_control_points on 2 batches of 36
     synthetic patches each from the shipped decoders (the refit on one
     batch of 4 patches), iou_from_embeddings on one shape's embedding;
     with h5py each CLI's main through h5 files, without it the same split
     functions in memory (which one is printed). Checks: generate's
     seg_id equal bit for bit to predict_segmentation's on the same
     shapes with one generator of the same seed; K1 f32 at least once a
     shape and K2 once a batch in generate, K3 4 times a shape in test (7
     with --optimize), K3 in the SplineNet tests, K1 f32 and one K2 in
     iou_from_embeddings; every refined surface and every metric finite.
     Prints ms a shape of each CLI, the quality beside phase 4's on the
     same shapes, cd and cd_optim;
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
     (b)-(d) run twice each from the same seed and data: the losses of
         every step and the validation chamfer must be equal;
  5e. e2e training (train_e2e), from params/parsenet_e2e.npz and the
     shipped decoders:
     (a) parity: two make_e2e_step steps on one shape of 2,048 points (k
         80, accum 1, lr 1e-4; E2E_PARITY, the draws parity_draws) within
         E2E_RTOL of the JAX package's (E2E_REFERENCE, from
         scripts/e2e_train_reference.py), clusters equal; the card's
         step-1 gradient of every tensor at cosine >= 0.99 with the plain
         path's on the machine's CPU, where both found as many clusters
         (else the skip is printed);
     (b) configs/config_parsenet_e2e.yml at full width through
         run_training: synthetic shapes of 10,000 points, 8,000 a step,
         batch 1, accum 5, k 80, lr 1e-4; 1 warm-up + 3 timed steps and
         the validation (eval_step on a fixed sample of 2 shapes): ms a
         step, shapes/s, stage ms (CUDA events), every step's metrics,
         peak memory; every value finite, grad_ok 1 at every step, K1
         (f32), K2, K3 and K4 launched; run twice from one seed, whether
         every metric repeats printed;
  5s. segmentation training (train_seg): (a) two parity steps from
     params/parsenet_e2e.npz, 2 micro-batches of 2 shapes of 1,024 points
     (SEG_PARITY), within SEG_RTOL of SEG_REFERENCE; (b)
     configs/config_parsenet_normals.yml at full width through
     run_training from the seeded initialisation: 7,000 of 10,000 points,
     batch 8, accum 3, k 80, lr 0.01, 1 warm-up + 3 timed steps, the
     validation on 8 fixed shapes; the same prints and checks as 5e (b)
     but the launches (the network runs no kernel of the port);
  7. (run before 6) the port's benches in process, every run's launches
     counted from zero: parsenet_tpu_torch.cli.bench.run at bench.py's
     full scale (stream a, 10,000 points, batch 4, 2 + 8 batches) for the
     full path (floors applied and met; the quality figures within 0.01
     absolute (seg_iou, sk_2) or 10% relative (residual, p_cov) of the
     JAX package's full path, BENCH_r05.json) and BENCH_DGCNN_BF16 /
     BENCH_GATHER_BF16 (floors met), K1 bf16, K2 and K3 launched in each
     and the f32 K1 not; then cli.bench_train, cut to 2 timed steps (seg;
     the script runs 5) or 3 (e2e) after one warm-up: seg, seg with
     BT_BF16 and with BT_REMAT (shapes/s, peak memory), e2e and e2e with
     BT_FAST (K1 f32, K2, K3, K4 launched); grad_ok 1 in every train run;
  6. kernel times at main-path shapes beside the plain version, the bound
     and the library yardstick where PyTorch computes the same
     (sdpa_mean_shift for K1 and, one step, K5, torch.cdist for K3,
     index_add_ for K4's scatter); for K1 also the achieved TFLOP/s, the
     share of the bound (f32: the smaller of the 3xTF32 tensor-core and
     the f32 FMA floors), the floor the exponentials set on the MUFU
     units, the bf16 launch alone, without the wrapper's tiling and
     allocations, and both kernels' two grids at 10,000 and 4,999 rows;
     the 3xTF32 kernel's operand probe (kernels.ms_tf32_operand_probe):
     on every SM, a key tile's score product in each operand layout, its
     update, and both, 8,192 tiles against operands held in shared memory,
     each with its cycles a tile, shared-memory bytes an FMA, bytes a
     clock an SM and share of the TF32 tensor rate (the fp16 lo.hi of
     score_rs_f16 runs at twice that rate, so its share can pass 100%),
     and the fixed-count K1 f32's clocks a tile (its 10,000 x 128 x 50
     time at the probe's clock) with the probe's score_rs+update and
     score_rs_f16+update as shares of it;
     K1 exit at 10,000 x 128 x 50, tol 1e-6, on the 8 stream-a embeddings in
     both modes beside tol = 0, with the iterations it runs as a share of
     50 (kernels.mean_shift_exit_counts), the fixed-count bound scaled by
     that share and the row blocks still iterating at each iteration; the
     same at the clustered 4,999, 10,000 and 20,000 rows of phase 3, where
     most row blocks leave early; K1 f32 at the e2e attempts' 8,000 x 128 x
     5 iterations; K3 and K4 at the e2e slot chamfer (K4 with the loss's
     gradient, and its longest chain);
     K2, both entries, on shape 0's
     SIOU matrix and on the first timed batch's 4 in one call: device and
     eager time, the rounds, the time a round (one call against a call
     capped at one round), the barrier, shuffle and redux.sync latencies of
     a clock64 probe (kernels.auction_latency_probe) and the latency bound,
     rounds x (one barrier + a 5-step shuffle reduction).
     Times are CUDA events around back-to-back eager calls (`cuda_ms`,
     what the program sees); K2, K3 (each of a shape's three inference
     calls, and the training call), K4 and their yardsticks also get a
     device time (`graph_ms`: the calls captured in a CUDA graph, events
     around its replays, so the host's pace is out of it).
  9. (run before 6) the last slice in one NCCL rank of a process group
     (parallel.mesh.make_mesh; the dry run below spawns one rank a card
     present): eval.sharded.make_batched_eval on stream a's first two
     timed batches, its metric sums equal to make_batched_eval(mesh=None)'s
     bit for bit, K1 bf16, K2 and K3 launched; ring_min_sqdist at 10,000 x
     10,000 equal to one K3 call bit for bit (K3 launched); ring_knn at
     10,000 x 128, k 80, equal to knn's indices; the e2e parity step
     (E2E_PARITY) and both SplineNet parity steps under the group equal to
     the ungrouped steps bit for bit (metrics, gradients, weights and
     running statistics), their kernels launched, the gradient all-reduce
     timed alone; mean_shift (K1 f32 once, within 1e-3 of its plain
     version; with grad on, autograd and no launch), match on shape 0's
     clustering (K2 once, equal to the CPU's lap_assign_plain), kmeans,
     spectral_cluster and cluster("meanshift") on shape 0's embedding
     (co-membership >= 0.999 with the plain run on the CPU; K1 f32 in the
     mean-shift branch), prefetch_to_device on 6 batches (equal and in
     order); `python -m parsenet_tpu_torch.cli.dryrun_multichip N` at N =
     the cards present, its two lines printed. The times of each, ms from
     the host clock around synchronised work;
  10. (run before 6) the route from a fine-tune to shipped weights, every
     launch of the phase counted from zero (finetune_phase, sizes in
     FT_SIZES): (a) cli.finetune_e2e's loop (finetune_config at full width:
     mode 5, k 80, embedding 128, 8,000 of 10,000 points, batch 1, accum
     5, lr 5e-5) from params/parsenet_e2e.npz and the shipped decoders, 1
     epoch of 2 optimizer steps on make_shape_batch(RandomState(40)), its
     fixed validation sample 4 shapes of RandomState(41) at val_points
     10,000; run twice from one seed: every step's metrics and the
     validation equal, the checkpoint loads back bit for bit, and a
     standalone eval_step of the trained network on the rebuilt 10,000-
     point sample gives val_seg_iou and val_res_loss bit for bit; ms a
     step (CUDA events); (b) cli.export_params of that checkpoint to a
     temporary directory: params/... float16, nothing else but float32;
     (c) the gate: cli.bench at the full protocol (10k points, 2 + 8
     batches of 4) for the candidate on stream a and on stream b and the
     shipped weights on stream b (ms a shape, quality), the shipped
     stream-a record phase 7's full run; cli.promote_candidate over them
     with --dest, --params-dir and --bank under a temporary directory
     (run_gate): cli.bench loaded the export, the gate decides (exit 0 or
     1; its checks printed) and every file of params/ keeps its sha256;
     (d) cli.validate_reference's two stages and parity table on stream-a
     shapes 8-15 in memory (f32 mean-shift, the 12 slots): every column
     finite, the labels equal predict_segmentation's bit for bit with one
     generator of the same seed; with h5py also its main through h5 files.
     Prints the phase's seconds and its launches of K1 f32, K1 bf16, K2, K3
     and K4, each of which must be above 0;
The last three lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}. A kernel's "launches" there sum its
launches on the paths the phases drive (stream a, 4b-4d, the trainers, the
benches of 7) and those of phases 9 and 10, which each entry also gives
apart ("launches_phase9", "launches_phase10"). Any failed check exits non-zero without the
ok line; without a CUDA device it exits 1 at once.
"""
import contextlib
import json
import os
import re
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
PEAK_TF32 = 495e12
HBM_BYTES_S = 3.35e12
# ex2 per second on the MUFU units: 132 SMs x 16 a clock (compute
# capability 9.0) at 1.83 GHz, the clock at which 132 x 4,096 bf16 FLOP a
# clock make the 989 TFLOP/s above
MUFU_EX2_S = 132 * 16 * 1.83e9
# TF32 FMA a clock an SM on the tensor cores: 495 TFLOP/s over 132 SMs at
# 1.83 GHz; and the key tiles of each run of the tf32 kernel's operand probe
TF32_FMA_CLOCK = PEAK_TF32 / 2 / 132 / 1.83e9
PROBE_TILES = 8192

# stream-a quality of the JAX package, printed beside the port's: the full
# path (BENCH_r05.json) and the spline-free path (artifacts/
# r5_infer_ablate.jsonl, arm "splines")
REFERENCE_FULL = {"seg_iou": 0.8907, "residual": 0.01019, "p_cov": 0.01588,
                  "sk_2": 0.8688}
REFERENCE_ABLATE = {"seg_iou": 0.8907, "residual": 0.00907, "p_cov": 0.01523,
                    "sk_2": 0.8899}
# Phase 7: the port's bench runs (environment knobs of cli.bench; each at
# bench.py's full scale: 10,000 points, batch 4, 2 + 8 batches of stream a)
BENCH_RUNS = {"full": {}, "dgcnn_bf16": {"BENCH_DGCNN_BF16": "1"},
              "gather_bf16": {"BENCH_GATHER_BF16": "1"}}
BENCH_QUALITY = ("residual", "seg_iou", "p_cov", "sk_2")
# K1's early exit: the tolerance scripts/ab_mean_shift.py A/Bs, a coarse
# one at which leaving early moves m by more than the limits below, and the
# seconds a launch of phase 3 may take before the run fails as hung
EXIT_TOL, EXIT_TOL_COARSE = 1e-6, 1e-3
HANG_S = 60.0
# the exits' second grid: a quarter of the SMs, so that at N >= 4,999 each
# block's run spans several row blocks
EXIT_SMALL_GRID = 33
# Where a row block of K1 exit leaves at another iteration than the plain
# version's, both deltas at the first disputed iteration must lie within
# this band of tol, by mode. f32: one iteration apart at most, both deltas
# within the rounding between the two trajectories' deltas (3xTF32 against
# f32 sums, about 2e-7 an iteration: the CPU emulation's 2.1e-7 against
# the Pallas kernel); bf16: the 1-iteration limit K1TC_TOL_1 below, with no
# bound on the iterations apart, since a block whose rows sit at bf16's
# rounding floor can stop dead (delta 0) or cycle between bf16 neighbours
# (delta ~1e-5) on either side.
EXIT_BAND = {"f32": 2.5e-7, "bf16": 1e-4}

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
# The 3xTF32 K1 (and K5) against the plain f32 version, max |d|: the
# operands are split to about 2^-21 relative and accumulated in f32, so one
# iteration differs by the order of the sums, the dropped lo.lo term and
# ex2.approx (CPU emulation against the Pallas kernel: 2.1e-07 at N =
# 2,048); 50 iterations let rows between modes drift a little apart. NMS
# co-membership on 8 stream-a embeddings must reach K1F_AGREE, or, on an
# embedding where plain f32 with its keys in another order (the same sums
# rounded in another order) already moves NMS more than that, reach the
# reordered version's co-membership: NMS takes argmaxes over rows that
# converged to one mode, which last-bit differences decide.
K1F_TOL_1, K1F_TOL_50, K1F_AGREE = 1e-5, 1e-3, 0.999

# The trainers' parity steps (phases 7a and 8a): sizes, seeds and lr; the
# shapes are make_shape_batch(RandomState(seed), shapes, points),
# mean-centred, from params/parsenet_e2e.npz, and every shape of a step
# takes the triplet draws parity_draws(seed)
E2E_PARITY = {"seed": 11, "shapes": 1, "points": 2048, "k": 80, "lr": 1e-4}
SEG_PARITY = {"seed": 12, "shapes": 4, "points": 1024, "k": 80, "lr": 0.01,
              "accum": 2}

# two steps of each trainer in the JAX package on the CPU (lr as above),
# the output of `python scripts/e2e_train_reference.py` (its grad_ok 1 at
# every step): each step's metrics before its update
E2E_REFERENCE = [
    {"clusters": 8.0, "embed_loss": 0.4991939663887024, "geom_loss":
     0.0403452143073082, "prim_iou": 0.625, "prim_loss": 1.4598302841186523,
     "res_loss": 0.042409975081682205, "seg_iou": 0.5129479169845581,
     "spline_loss": 0.45851245522499084},
    {"clusters": 9.0, "embed_loss": 0.4978553056716919, "geom_loss":
     0.06925144046545029, "prim_iou": 0.6666666865348816, "prim_loss":
     1.4467382431030273, "res_loss": 0.05119125545024872, "seg_iou":
     0.48855698108673096, "spline_loss": 0.15070897340774536}]
SEG_REFERENCE = [
    {"embed_loss": 0.6023057699203491, "miou": 0.558760404586792, "prim_loss":
     1.519356369972229},
    {"embed_loss": 0.5503126978874207, "miou": 0.5884276628494263, "prim_loss":
     1.1674134731292725}]
# Relative tolerance of each step's metrics (step 1, step 2), of at least
# 1e-3 absolute. The port's plain path on the CPU came within 1.3e-4 of
# the JAX package at step 1 (spline_loss) and 9.7e-4 at step 2 (seg_iou,
# after Adam's first update, which moves every weight by lr whatever its
# gradient's size). clusters differ by one cluster at least, so they must
# be equal.
E2E_RTOL = (2e-3, 1e-2)
SEG_RTOL = (1e-3, 5e-3)
# The card's e2e step-1 gradient of each tensor against the port's plain
# path on the CPU, by cosine
E2E_GRAD_COS = 0.99


def parity_draws(seed):
    """The triplet loss's uniforms of one parity shape: (u_points [S_MAX,
    P_SAMPLES], u_pairs [N_PAIRS, 2]) f32 from numpy's RandomState(seed +
    100); scripts/e2e_train_reference.py hands the same to the JAX
    package."""
    import numpy as np
    from parsenet_tpu_torch.losses.embedding import N_PAIRS, P_SAMPLES, S_MAX
    rs = np.random.RandomState(seed + 100)
    return (rs.rand(S_MAX, P_SAMPLES).astype(np.float32),
            rs.rand(N_PAIRS, 2).astype(np.float32))


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


def sass_count_by_function(lib, op):
    """{function (mangled name): lines holding the instruction `op`} of
    `cuobjdump -sass lib`."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and op in line:
            counts[fn] += 1
    return counts


def guarded(fn, seconds=HANG_S):
    """fn() and a synchronize in a watchdog thread: its result, or, if it
    has not returned within `seconds` (a launch that hangs the card), the
    run fails at once, with exit code 3 and no ok line. The kernels' own
    waits trap after 4 s, so a hang shows as an error first."""
    import threading
    import torch
    box = {}

    def run():
        try:
            box["out"] = fn()
            torch.cuda.synchronize()
        except BaseException as e:   # noqa: BLE001 - handed to the caller
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    if th.is_alive():
        print(f"chip_smoke: FAILED: a launch did not return within "
              f"{seconds:g} s (hung)", file=sys.stderr, flush=True)
        os._exit(3)
    if "err" in box:
        raise box["err"]
    return box["out"]


def sass_loop(lib, kernel):
    """The innermost hot loop of `kernel` (a substring of its mangled name)
    in `cuobjdump -sass lib`: the backward branch's body with the most FFMA.
    -> (instructions, FFMA, LDS) in that body, or None if none is found."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    ins, inside = [], False   # (address, text) of the kernel's instructions
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if inside and m:
            ins.append((int(m.group(1), 16), m.group(2)))
    best = None
    for addr, text in ins:   # cuobjdump gives branch targets as addresses
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        target = int(m.group(1), 16)
        body = [t for a, t in ins if target <= a <= addr]
        ffma = sum(re.search(r"\bFFMA\b", t) is not None for t in body)
        if best is None or ffma > best[1]:
            best = (len(body), ffma,
                    sum(re.search(r"\bLDS\b", t) is not None for t in body))
    return best


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps calls after one warm-up, by CUDA events
    around back-to-back eager calls: what the program sees, host work
    included where the host cannot keep ahead of the card."""
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


def graph_ms(fn, reps, replays=5):
    """Device ms of one fn() call: reps calls captured in one CUDA graph,
    CUDA events around `replays` replays of it, so the host's pace and the
    wrapper's Python are out of the time and only the launches' device
    work (and the gaps between graph nodes) remain."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the default stream
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def time_k3(kernels, q, x, reps):
    """K3 (`kernels` is a tree's parsenet_tpu_torch.ops.kernels) on q, x
    and its yardstick torch.cdist(q, x).pow(2).min: eager and device ms."""
    import torch
    fn = lambda: kernels.min_sqdist_with_idx(q, x)   # noqa: E731
    lib = lambda: torch.cdist(q, x).pow(2).min(-1)   # noqa: E731
    return {"ms": cuda_ms(fn, reps), "device_ms": graph_ms(fn, reps),
            "library_ms": cuda_ms(lib, 3),
            "library_device_ms": graph_ms(lib, 3)}


def time_k4(kernels, q, x, idx, g, reps):
    """K4 on the argmins idx and the gradient g, and its yardstick, the
    scatter of -dq alone by one index_add_: eager and device ms. "ms" is
    the call MinSqdist.backward makes (the unchecked _min_sqdist_bwd; an
    older checkout without it called min_sqdist_bwd), "checked_ms" the
    public wrapper with its checks."""
    import torch
    b, m = x.shape[0], x.shape[1]
    rows = (idx.long() + m * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    dq = kernels.min_sqdist_bwd_plain(q, x, idx, g)[0].reshape(-1, 3)
    dx = torch.zeros((b * m, 3), device=x.device)
    bwd = getattr(kernels, "_min_sqdist_bwd", kernels.min_sqdist_bwd)
    fn = lambda: bwd(q, x, idx, g)                            # noqa: E731
    checked = lambda: kernels.min_sqdist_bwd(q, x, idx, g)    # noqa: E731
    lib = lambda: dx.index_add_(0, rows, dq, alpha=-1.0)      # noqa: E731
    return {"ms": cuda_ms(fn, reps), "checked_ms": cuda_ms(checked, reps),
            "device_ms": graph_ms(fn, reps),
            "library_ms": cuda_ms(lib, reps),
            "library_device_ms": graph_ms(lib, reps)}


def k3_line(t):
    return (f"kernel {t['ms']:.4f} ms eager, {t['device_ms']:.4f} ms device; "
            f"cdist {t['library_ms']:.4f} ms eager, "
            f"{t['library_device_ms']:.4f} ms device")


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
    """Queries whose second-nearest target is more than `margin` farther
    (every query, where there is one target)."""
    import torch
    if x.shape[0] < 2:
        return torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    out = []
    for s in range(0, q.shape[0], chunk):
        d = torch.cdist(q[s:s + chunk].double(), x.double()).pow(2)
        two = torch.topk(d, 2, dim=1, largest=False).values
        out.append(two[:, 1] - two[:, 0] > margin)
    return torch.cat(out)


def sdpa_mean_shift(X, bandwidth, iterations, m0=None):
    """K1's and K5's library yardstick, timed beside them and used nowhere
    in the port: `iterations` steps of m <- normalize(softmax(2 inv2b2 m
    X^T) X) from m = X (or the queries m0), one
    F.scaled_dot_product_attention each, in X's dtype. The softmax's max
    shift cancels the kernel's constant factor exp(-2 inv2b2), so in f32
    this is kernels.mean_shift_iterations_plain (and, for one step from m0,
    kernels.mean_shift_step_plain) up to round-off."""
    import torch
    import torch.nn.functional as F
    scale = 1.0 / float(bandwidth) ** 2      # 2 inv2b2
    x = X[None, None]
    m = x if m0 is None else m0[None, None]
    for _ in range(iterations):
        m = F.scaled_dot_product_attention(m, x, x, scale=scale)
        m = m / (torch.linalg.norm(m, dim=-1, keepdim=True) + 1e-12)
    return m[0, 0]


def k1_launch(kernels, x, bandwidth, bf16, iterations, tol=0.0, iters=None,
              grid=None):
    """One launch of a tensor-core K1 under the watchdog -> [N, D]: at tol
    = 0 the fixed-count kernel on ms_plan's grid; at tol > 0 its exit
    kernel on at most `grid` blocks (default every SM), `iters` receiving
    each row block's iterations."""
    n, d = x.shape
    inv = kernels._inv2b2(bandwidth, x.device)
    sms = kernels._sm_count(x.device)
    if tol > 0.0:
        return guarded(lambda: kernels._ms_exit(
            x, inv, iterations, grid or sms, tol, bf16, iters)[:, :d])
    if bf16:
        return guarded(lambda: kernels._ms_iterations_tc(
            x, inv, iterations, kernels.ms_plan(n, sms)[0])[:, :d])
    return guarded(lambda: kernels._ms_iterations_tf32(
        x, x, inv, iterations,
        kernels.ms_plan(n, sms, kernels.MS_TF32_TILE)[0])[:, :d])


def block_max(v, rows):
    """Per-row values [N] -> the max over each `rows`-row block."""
    import torch
    n = v.shape[0]
    pad = torch.full((-(-n // rows) * rows - n,), -float("inf"),
                     device=v.device, dtype=v.dtype)
    return torch.cat([v, pad]).view(-1, rows).amax(1)


def exit_check(kernels, x, bandwidth, bf16, grid, tol, iterations=50):
    """K1 exit against its rule: two exit launches (equal bit for bit),
    then the kernel's own trajectory, the same launch capped at 1, 2, ...
    iterations (up to the cap, it makes the same decisions and so the same
    splits): each 128-row block must have run exactly the iterations up to
    the first whose delta (max |m_j - m_(j-1)| over its rows) is <= tol,
    all `iterations` if none, and its rows must be that iteration's m (max
    |d| returned). In bf16 the first iteration must be the fixed-count
    kernel's bit for bit where both split the work alike (the f32 exit adds
    its tiles in chains, the fixed-count kernel does not). Beside it the
    plain version's counts at exit_rows = 128 (kernels._ms_plain), and
    where they differ, both deltas at the first disputed iteration. -> dict
    of the counts, the mismatches ((block, kernel, plain, kernel delta,
    plain delta)), the errors and the live row blocks of each iteration."""
    import torch
    rows = kernels.MS_BLOCK_ROWS
    n = x.shape[0]
    blocks = -(-n // rows)
    iters = torch.zeros((blocks,), dtype=torch.int32, device=x.device)
    out = k1_launch(kernels, x, bandwidth, bf16, iterations, tol, iters, grid)
    iters2 = torch.zeros_like(iters)
    out2 = k1_launch(kernels, x, bandwidth, bf16, iterations, tol, iters2,
                     grid)
    repeat = bool(torch.equal(out, out2) and torch.equal(iters, iters2))
    got = iters.long()
    rule = torch.full((blocks,), iterations, dtype=torch.long,
                      device=x.device)
    found = torch.zeros((blocks,), dtype=torch.bool, device=x.device)
    traj = []                                  # the kernel's own deltas
    err_m = torch.zeros((blocks,), device=x.device)
    prev = x
    first_fixed = None
    sms = kernels._sm_count(x.device)
    if bf16 and blocks < sms and kernels.ms_plan(n, sms)[0] == (
            kernels.ms_exit_active(blocks, -(-n // kernels.MS_TILE),
                                   min(grid or sms, sms))):
        first_fixed = False
    _, plain, p_delta = kernels._ms_plain(x, bandwidth, iterations, bf16,
                                          tol, rows)
    last = max(int(got.max()), int(plain.max()))
    for j in range(1, iterations + 1):
        m_j = k1_launch(kernels, x, bandwidth, bf16, j, tol, None, grid)
        if j == 1 and first_fixed is not None:
            first_fixed = bool(torch.equal(
                m_j, k1_launch(kernels, x, bandwidth, bf16, 1)))
        delta = block_max((m_j - prev).abs().amax(1), rows)
        traj.append(delta)
        hit = ~found & ~(delta > tol)
        rule = torch.where(hit, j, rule)
        found |= hit
        at = block_max((out - m_j).abs().amax(1), rows)
        err_m = torch.where(got == j, at, err_m)
        prev = m_j
        if bool(found.all()) and j >= last:
            break
    diff = []
    for b in torch.nonzero(got != plain).flatten().tolist():
        j = min(int(got[b]), int(plain[b])) - 1      # the first disputed
        diff.append((b, int(got[b]), int(plain[b]),
                     float(traj[j][b]) if j < len(traj) else None,
                     float(p_delta[j, b])))
    return {"kernel": got.tolist(), "rule": rule.tolist(),
            "plain": plain.tolist(), "rule_ok": bool((got == rule).all()),
            "max_abs_err_m": float(err_m.max()), "plain_diff": diff,
            "repeat": repeat, "first_fixed": first_fixed,
            "live": live_per_iteration(iters, iterations), "out": out}


def runs(values):
    """[79, 79, 79, 60] -> "79 x 3, 60": a list with its repeats folded."""
    out, i = [], 0
    while i < len(values):
        j = i
        while j < len(values) and values[j] == values[i]:
            j += 1
        out.append(f"{values[i]}" + (f" x {j - i}" if j - i > 1 else ""))
        i = j
    return ", ".join(out)


def live_per_iteration(iters, iterations):
    """The row blocks still iterating at each iteration, from an exit
    launch's iterations per row block."""
    v = iters.long().cpu()
    return [int((v > j).sum()) for j in range(iterations)]


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


# Phase 9: the data-parallel trainers, the sharded inference, the ring ops
# and the library functions of the port's last slice. Sizes are arguments
# so that the phase can be rehearsed on the CPU at a small size.
DP_SIZES = {"eval_batches": 2, "ring_points": 10000, "knn_k": 80,
            "cluster_rows": 10000, "prefetch_batches": 6}


def dp_phase(dev, report, model, spline_fit, shapes, embn, e2e_step_inputs,
             spline_inputs, sizes=DP_SIZES):
    """Phase 9 (see the module docstring). shapes: stream a's (pts,
    normals, labels, prim) and its first two timed batches' slices;
    e2e_step_inputs: (make_model, batch) for the e2e parity step;
    spline_inputs: {name: (make_model, batch)} plus nu, nv."""
    import numpy as np
    import torch
    from parsenet_tpu_torch.data.prefetch import prefetch_to_device
    from parsenet_tpu_torch.eval.sharded import make_batched_eval
    from parsenet_tpu_torch.models.splinenet import params_to_jax
    from parsenet_tpu_torch.ops import cluster_alt, kernels
    from parsenet_tpu_torch.ops import knn as knn_ops
    from parsenet_tpu_torch.ops import mean_shift as ms
    from parsenet_tpu_torch.ops.segmentation import match
    from parsenet_tpu_torch.parallel import ring
    from parsenet_tpu_torch.parallel.mesh import make_mesh
    from parsenet_tpu_torch.train import train_e2e as te2e
    from parsenet_tpu_torch.train import train_spline as tsp
    from parsenet_tpu_torch.train.state import make_optimizer

    out = report["dp"] = {}
    total = {k: 0 for k in kernels.LAUNCHES}
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def counted(fn):
        """fn() with the launch counts zeroed before and read after: its
        result, its launches (added to the phase's), its host ms."""
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        r = fn()
        sync()
        ms_ = 1000.0 * (time.perf_counter() - t0)
        got = dict(kernels.LAUNCHES)
        for k, v in got.items():
            total[k] += v
        return r, got, ms_

    def timed(fn, reps=3):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return 1000.0 * (time.perf_counter() - t0) / reps

    def in_turns(grouped_fn, alone_fn, rounds=3):
        """Host ms of one call each, grouped and alone, over `rounds`
        rounds in turns (grouped, alone, alone, grouped, ...)."""
        ms_ = {True: [], False: []}
        for r in range(2 * rounds):
            first = r % 2 == 0
            for which in ((True, False) if first else (False, True)):
                sync()
                t0 = time.perf_counter()
                (grouped_fn if which else alone_fn)()
                sync()
                ms_[which].append(1000.0 * (time.perf_counter() - t0))
        return (float(np.mean(ms_[True][1:])), float(np.mean(ms_[False][1:])))

    mesh = make_mesh(device=dev)
    print(f"[9 dp] process group: {mesh.world} rank(s), backend "
          f"{torch.distributed.get_backend()}, device {mesh.device} "
          f"(cards present: {cards})", flush=True)
    check(mesh.world == 1 and torch.distributed.get_backend() == (
        "nccl" if dev.type == "cuda" else "gloo"),
        "phase 9 runs in one NCCL rank in this process")
    try:
        # (a) sharded inference: stream a's first two timed batches
        pts, normals, labels, prim, batches = shapes
        kw = dict(ms_bf16=True, ms_num_samples=5000)
        grouped = make_batched_eval(model, spline_fit, mesh, **kw)
        alone = make_batched_eval(model, spline_fit, None, device=dev, **kw)
        res = {"launches": {k: 0 for k in kernels.LAUNCHES}, "equal": True,
               "ms_per_shape": [0.0, 0.0], "sums": []}
        s0 = batches[0]      # warm-up: the network's one-shape batches
        alone(pts[s0][:1], normals[s0][:1], labels[s0][:1], prim[s0][:1],
              seed=0)
        for b, s in enumerate(batches[:sizes["eval_batches"]]):
            args = (pts[s], normals[s], labels[s], prim[s])
            seed = 1_000_003 + b

            def run_alone():
                sync()
                t0 = time.perf_counter()
                r = alone(*args, seed=seed)
                sync()
                return r, 1000.0 * (time.perf_counter() - t0)

            # in turns: the unsharded program first on even batches
            if b % 2 == 0:
                u, u_ms = run_alone()
            g, launch, g_ms = counted(lambda: grouped(*args, seed=seed))
            if b % 2 == 1:
                u, u_ms = run_alone()
            for k, v in launch.items():
                res["launches"][k] += v
            n_b = s.stop - s.start
            res["ms_per_shape"][0] += g_ms / n_b
            res["ms_per_shape"][1] += u_ms / n_b
            res["equal"] &= bool(torch.equal(g, u))
            res["sums"].append(g.cpu().tolist())
        nb = min(sizes["eval_batches"], len(batches))
        res["ms_per_shape"] = [v / nb for v in res["ms_per_shape"]]
        shapes_n = sum(s.stop - s.start for s in batches[:nb])
        means = np.sum(res["sums"], 0) / shapes_n
        out["sharded_eval"] = res
        print(f"[9 dp] sharded eval, {shapes_n} stream-a shapes: "
              f"{res['ms_per_shape'][0]:.1f} ms a shape under the group, "
              f"{res['ms_per_shape'][1]:.1f} without; residual "
              f"{means[0]:.5f} seg_iou {means[1]:.4f} p_cov {means[2]:.5f} "
              f"sk_2 {means[3]:.4f}; launches {res['launches']}",
              flush=True)
        check(res["equal"], "sharded eval: the metric sums under the group "
              "equal make_batched_eval(mesh=None)'s bit for bit")
        check(bool(np.isfinite(res["sums"]).all()) and means[1] > 0.5,
              f"sharded eval: finite sums, seg_iou {means[1]:.4f} > 0.5")
        for kname in ("K1tc", "K2", "K3"):
            check(res["launches"][kname] > 0, f"sharded eval launched "
                  f"{kname} ({res['launches'][kname]})")

        # (b) ring_min_sqdist at 10,000 x 10,000: one K3 call at W = 1
        n_r = sizes["ring_points"]
        q = torch.from_numpy(pts[0][:n_r]).to(dev).contiguous()
        x = torch.from_numpy(pts[1][:n_r]).to(dev).contiguous()
        (d, i), launch, _ = counted(lambda: ring.ring_min_sqdist(mesh, q, x))
        d1, i1 = kernels.min_sqdist_with_idx(q, x)
        ring_ms = timed(lambda: ring.ring_min_sqdist(mesh, q, x), 10)
        k3_ms = timed(lambda: kernels.min_sqdist_with_idx(q, x), 10)
        out["ring_min_sqdist"] = {"launches": launch, "ms": ring_ms,
                                  "k3_ms": k3_ms}
        print(f"[9 dp] ring_min_sqdist {n_r}x{n_r}: {ring_ms:.3f} ms, one "
              f"K3 call {k3_ms:.3f} ms; launches {launch}", flush=True)
        check(torch.equal(d, d1) and torch.equal(i, i1),
              "ring_min_sqdist equals one K3 call bit for bit at W = 1")
        check(launch["K3"] >= 1, f"ring_min_sqdist launched K3 "
              f"({launch['K3']})")

        # (c) ring_knn at 10,000 x 128 against knn
        e = embn[:n_r].contiguous()
        kk = sizes["knn_k"]
        nb_ring = ring.ring_knn(mesh, e, kk)
        nb_knn = knn_ops.knn(e[None], kk)[0]
        same = float((nb_ring.to(torch.int64) == nb_knn).float().mean())
        # knn's scores, as knn forms them: where the indices differ, the
        # scores must tie exactly (torch.topk orders ties as it likes,
        # ring_knn as lax.top_k: the lower index first)
        eb, c_ = e[None], knn_ops._row_chunks(n_r)
        xt, xx = eb.transpose(1, 2), torch.sum(eb * eb, dim=-1)[:, None, :]
        score = torch.cat([(2.0 * (eb[:, r0:r0 + c_] @ xt)
                            - torch.sum(eb[:, r0:r0 + c_] ** 2, dim=-1)[
                                ..., None] - xx)[0]
                           for r0 in range(0, n_r, c_)])
        tied = torch.equal(torch.gather(score, 1, nb_ring.to(torch.int64)),
                           torch.gather(score, 1, nb_knn))
        del score
        rk_ms = timed(lambda: ring.ring_knn(mesh, e, kk))
        kn_ms = timed(lambda: knn_ops.knn(e[None], kk))
        out["ring_knn"] = {"equal_share": same, "ms": rk_ms, "knn_ms": kn_ms,
                           "scores_equal": tied}
        print(f"[9 dp] ring_knn {n_r}x{e.shape[1]} k {kk}: {rk_ms:.3f} ms, "
              f"knn {kn_ms:.3f} ms; indices equal at {100 * same:.4f}%, the "
              f"rest exact ties of knn's scores: {tied}", flush=True)
        check(tied, "ring_knn equals knn's indices, up to the order of "
              "exactly tied scores")

        # (d) the e2e step under the group and without it, bit for bit
        make_model, fit, batch = e2e_step_inputs
        m_g, m_u = make_model(), make_model()
        st_g = te2e.make_e2e_step(m_g, fit, make_optimizer(
            m_g.parameters(), "adam", 1e-4), mesh=mesh)[0]
        st_u = te2e.make_e2e_step(m_u, fit, make_optimizer(
            m_u.parameters(), "adam", 1e-4))[0]
        mg, launch, _ = counted(lambda: st_g(*batch))
        mu = st_u(*batch)
        same_m = all(float(mg[k]) == float(mu[k]) for k in mu)
        same_p = all(torch.equal(a, b) for a, b in zip(m_g.parameters(),
                                                        m_u.parameters()))
        same_g = all(torch.equal(a.grad, b.grad) for a, b in
                     zip(m_g.parameters(), m_u.parameters()))
        params = list(m_g.parameters())
        ar_ms = timed(lambda: mesh.all_reduce_grads(params), 20)
        n_par = sum(p.numel() for p in params)
        g_ms, u_ms = in_turns(lambda: st_g(*batch), lambda: st_u(*batch))
        out["e2e_step"] = {"launches": launch, "grouped_ms": g_ms,
                           "alone_ms": u_ms, "all_reduce_ms": ar_ms,
                           "grad_floats": n_par,
                           "metrics": {k: float(v) for k, v in mg.items()}}
        print(f"[9 dp] e2e step under the group {g_ms:.1f} ms, without "
              f"{u_ms:.1f} ms (steps 2-7, in turns); the gradient "
              f"all-reduce alone ({n_par} floats, {mesh.world} rank) "
              f"{ar_ms:.3f} ms; launches {launch}", flush=True)
        check(same_m and same_g and same_p, "e2e step under the group equals "
              f"the ungrouped step bit for bit (metrics {same_m}, gradients "
              f"{same_g}, weights after {same_p})")
        for kname in ("K1", "K2", "K3", "K4"):
            check(launch[kname] > 0, f"the grouped e2e step launched {kname} "
                  f"({launch[kname]})")

        # (e) the SplineNet step, open and closed
        nu, nv = spline_inputs["basis"]
        for sname in ("open", "closed"):
            make_sn, sbatch = spline_inputs[sname]
            a_, b_ = make_sn(), make_sn()
            closed = sname == "closed"
            sg = tsp.make_train_step(a_, make_optimizer(a_.parameters()), nu,
                                     nv, GRID, closed, True, mesh)[0]
            su = tsp.make_train_step(b_, make_optimizer(b_.parameters()), nu,
                                     nv, GRID, closed, True)[0]
            rg, launch, _ = counted(lambda: sg(*sbatch, 1e-3, 0.9))
            ru = su(*sbatch, 1e-3, 0.9)
            fa, fb = params_to_jax(a_), params_to_jax(b_)
            same = (all(float(rg[k]) == float(ru[k]) for k in ru)
                    and all(np.array_equal(fa[k], fb[k]) for k in fa)
                    and all(torch.equal(p.grad, r.grad) for p, r in
                            zip(a_.parameters(), b_.parameters())))
            g_ms, u_ms = in_turns(lambda: sg(*sbatch, 1e-3, 0.9),
                                  lambda: su(*sbatch, 1e-3, 0.9))
            out[f"spline_step_{sname}"] = {"launches": launch,
                                           "grouped_ms": g_ms,
                                           "alone_ms": u_ms}
            print(f"[9 dp] SplineNet {sname} step under the group "
                  f"{g_ms:.1f} ms, without {u_ms:.1f} ms (steps 2-7, in "
                  f"turns); launches {launch}", flush=True)
            check(same, f"SplineNet {sname} step under the group equals the "
                  "ungrouped step bit for bit (metrics, gradients, weights "
                  "and running statistics)")
            check(launch["K3"] > 0 and launch["K4"] > 0,
                  f"the grouped SplineNet {sname} step launched K3 and K4")

        # (f) library functions on the card
        rows = sizes["cluster_rows"]
        e = embn[:rows].contiguous()
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        subset = torch.randperm(rows, generator=g, device=dev)
        (shifted, bw_m), launch, m_ms = counted(lambda: ms.mean_shift(
            e, 0.015, num_samples=5000, iterations=10, subset=subset))
        plain = kernels.mean_shift_iterations_plain(e, bw_m, 10)
        err = float((shifted - plain).abs().max())
        out["mean_shift"] = {"launches": launch, "ms": m_ms,
                             "max_abs_err": err}
        print(f"[9 dp] mean_shift {rows}x{e.shape[1]}, 10 iterations: "
              f"{m_ms:.2f} ms, max |d| from K1 f32's plain version {err:.2e};"
              f" launches {launch}", flush=True)
        check(err <= K1F_TOL_50 and launch["K1"] == 1,
              f"mean_shift launched K1 f32 once and stays within "
              f"{K1F_TOL_50} of its plain version ({err:.2e})")
        xg = e[:2048].clone().requires_grad_()
        (sg_, _), launch, _ = counted(lambda: ms.mean_shift(
            xg, 0.015, num_samples=2048, iterations=10))
        torch.sum(sg_).backward()
        check(bool(torch.isfinite(xg.grad).all()) and launch["K1"] == 0,
              "mean_shift with grad on runs with autograd (no K1 launch), "
              "finite gradient")
        guard = ms.guard_mean_shift(e, 0.015, iterations=30, subset=subset)
        gt = torch.from_numpy(labels[0][:rows]).to(dev)
        perm, launch, mt_ms = counted(lambda: match(gt, guard.labels))
        perm_cpu = match(gt.cpu(), guard.labels.cpu())
        out["match"] = {"launches": launch, "ms": mt_ms}
        print(f"[9 dp] match on shape 0's clustering ({guard.num_clusters} "
              f"clusters): {mt_ms:.3f} ms; launches {launch}", flush=True)
        check(torch.equal(perm.cpu(), perm_cpu) and launch["K2"] == 1,
              "match launched K2 once and equals lap_assign_plain's "
              "permutation")
        k = max(2, min(guard.num_clusters, 20))
        v0 = torch.from_numpy(np.random.RandomState(4).randn(rows, k)
                              .astype(np.float32))
        e_cpu = e.cpu()
        for method, kw_c in (("kmeans", {"first": 0}),
                             ("spectral", {"first": 0, "v0": v0}),
                             ("meanshift", {"subset": subset})):
            on_dev = {kk_: (vv.to(dev) if torch.is_tensor(vv) else vv)
                      for kk_, vv in kw_c.items()}
            on_cpu = {kk_: (vv.cpu() if torch.is_tensor(vv) else vv)
                      for kk_, vv in kw_c.items()}
            lab_d, launch, c_ms = counted(lambda: cluster_alt.cluster(
                e, k, method, **on_dev))
            t0 = time.perf_counter()
            lab_c = cluster_alt.cluster(e_cpu, k, method, **on_cpu)
            c_cpu_ms = 1000.0 * (time.perf_counter() - t0)
            agree = co_membership(lab_d.cpu().numpy(), lab_c.numpy())
            out[f"cluster_{method}"] = {"launches": launch, "ms": c_ms,
                                        "cpu_ms": c_cpu_ms,
                                        "co_membership": agree}
            print(f"[9 dp] cluster {method} k {k} on {rows} rows: {c_ms:.1f}"
                  f" ms on the card, {c_cpu_ms:.1f} ms plain on the CPU, "
                  f"co-membership {agree:.5f}; launches {launch}", flush=True)
            check(agree >= 0.999, f"cluster {method}: co-membership "
                  f"{agree:.5f} >= 0.999 with the CPU's plain run")
            if method == "meanshift":
                check(launch["K1"] > 0, "cluster meanshift launched K1 f32")

        # (g) prefetch_to_device: pinned memory, a side stream
        host = [(pts[s], normals[s], labels[s]) for s in
                batches[:sizes["prefetch_batches"]]]
        t0 = time.perf_counter()
        got = []
        for batch in prefetch_to_device(iter(host), 2, dev):
            got.append(tuple(t.clone() for t in batch))
        sync()
        pf_ms = 1000.0 * (time.perf_counter() - t0) / len(host)
        t0 = time.perf_counter()
        for batch in host:
            tuple(torch.as_tensor(a).to(dev) for a in batch)
        sync()
        plain_ms = 1000.0 * (time.perf_counter() - t0) / len(host)
        ok = len(got) == len(host) and all(
            t.device.type == dev.type and torch.equal(
                t.cpu(), torch.as_tensor(a))
            for bt, bh in zip(got, host) for t, a in zip(bt, bh))
        out["prefetch"] = {"ms_per_batch": pf_ms, "plain_ms": plain_ms}
        print(f"[9 dp] prefetch_to_device {len(host)} batches: "
              f"{pf_ms:.2f} ms a batch, plain copies {plain_ms:.2f} ms",
              flush=True)
        check(ok, "prefetch_to_device: every batch on the device, equal and "
              "in order")
    finally:
        mesh.close()

    # (h) the dry run at N = the cards present, in its own process(es)
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "parsenet_tpu_torch.cli.dryrun_multichip",
           str(cards)]
    if dev.type != "cuda":
        cmd += ["--device", "cpu", "--points", "256", "--k", "8"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip")]
    out["dryrun"] = {"rc": proc.returncode, "lines": lines,
                     "s": time.perf_counter() - t0}
    for ln in lines:
        print(f"  {ln}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], flush=True)
    check(proc.returncode == 0 and len(lines) == 2
          and "nan" not in " ".join(lines),
          f"dryrun_multichip {cards} ran ({out['dryrun']['s']:.1f} s)")
    out["launches"] = total
    print(f"[9 dp] launches of the phase's drive {total}", flush=True)
    return out


# Phase 10: the route from a fine-tune to shipped weights. Sizes are
# arguments so that the phase can be rehearsed on the CPU at a small size.
FT_SIZES = {"shape_points": 10000, "steps": 2, "val_shapes": 4,
            "val_points": 10000, "config": {}, "bench_env": {},
            "proto": slice(8, 16)}


def params_digest(root=os.path.join(REPO, "params")):
    """{file: sha256} of every file under params/."""
    import hashlib
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def run_gate(records, cand, work):
    """cli.promote_candidate on the bench records {cand_a, cand_b,
    shipped_b, shipped_a}, written as JSON under work, with --dest and
    --params-dir in work (never params/) and --bank work/gate_bank ->
    (exit code, the gate's output)."""
    import io
    from parsenet_tpu_torch.cli import promote_candidate
    gate = os.path.join(work, "gate")
    os.makedirs(os.path.join(gate, "params"), exist_ok=True)
    paths = {}
    for tag, rec in records.items():
        paths[tag] = os.path.join(gate, f"{tag}.json")
        with open(paths[tag], "w") as f:
            json.dump(rec, f)
    args = ["--cand", cand, "--gate-a", paths["cand_a"],
            "--gate-b", paths["cand_b"], "--shipped-b", paths["shipped_b"],
            "--shipped-a-json", paths["shipped_a"],
            "--dest", os.path.join(gate, "params", "parsenet_e2e.npz"),
            "--params-dir", os.path.join(gate, "params"),
            "--bank", os.path.join(gate, "bank")]
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        try:
            promote_candidate.main(args)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, buf.getvalue()


def finetune_phase(dev, report, model, spline_fit, shapes, bench_a=None,
                   sizes=FT_SIZES):
    """Phase 10 (see the module docstring). shapes: stream a's
    canonicalised (pts, normals, labels, prim); bench_a: a cli.bench
    record of the shipped weights on stream a at the full protocol (phase
    7's), run here where None."""
    import shutil
    import numpy as np
    import torch
    from parsenet_tpu_torch.cli import bench as cbench
    from parsenet_tpu_torch.cli import export_params as cexport
    from parsenet_tpu_torch.cli import finetune_e2e as cft
    from parsenet_tpu_torch.cli import validate_reference as cval
    from parsenet_tpu_torch.core.checkpoint import load_npz_params
    from parsenet_tpu_torch.core.profiling import StageTimer
    from parsenet_tpu_torch.data.synthetic import make_shape_batch
    from parsenet_tpu_torch.eval import pipeline as tp
    from parsenet_tpu_torch.models.dgcnn import params_to_jax
    from parsenet_tpu_torch.ops import kernels
    from parsenet_tpu_torch.train import train_e2e as te2e
    from parsenet_tpu_torch.train.state import (make_optimizer, mean_metrics,
                                                pack_batch,
                                                validation_batches,
                                                validation_sample)

    out = report["finetune"] = {}
    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "finetune")
    shutil.rmtree(work, ignore_errors=True)
    before = params_digest()
    kernels.reset_launches()

    # (a) cli.finetune_e2e's loop from the shipped weights and decoders
    conf = cft.finetune_config(epochs=1, log_dir=os.path.join(work, "logs"),
                               **sizes["config"])
    per_step = conf.batch_size * conf.accum
    n_pts, n_val = sizes["shape_points"], sizes["val_shapes"]
    tr = make_shape_batch(np.random.RandomState(40),
                          sizes["steps"] * per_step, n_pts)
    va = make_shape_batch(np.random.RandomState(41), n_val, n_pts)

    def val_gen():
        b = conf.batch_size
        return (tuple(a[i:i + b] for a in va) for i in range(0, n_val, b))

    def run(i):
        timer = StageTimer(dev.type == "cuda")
        tr_gen = (tuple(a[j:j + per_step] for a in tr)
                  for j in range(0, len(tr[0]), per_step))
        t0 = time.perf_counter()
        res = cft.finetune(conf, val_shapes=n_val,
                           val_points=sizes["val_points"], train_gen=tr_gen,
                           val_gen=val_gen(), steps_per_epoch=sizes["steps"],
                           points_per_shape=conf.num_points,
                           spline_fit=spline_fit, device=dev, timer=timer)
        s = time.perf_counter() - t0
        step_ms = []
        if timer.enabled:
            timer.ms()
            fwd, opt = timer.events["dgcnn_forward"], timer.events["optimizer"]
            step_ms = [fwd[j * conf.accum][0].elapsed_time(opt[j][1])
                       for j in range(len(opt))]
        ep = res.epochs[0]
        print(f"[10 finetune] run {i}: {sizes['steps']} steps of {per_step} "
              f"shapes x {conf.num_points} points (k {conf.knn_k}, accum "
              f"{conf.accum}, lr {conf.lr:g}), ms a step "
              f"{[round(v, 1) for v in step_ms] or 'not measured'}; "
              f"validation on {n_val} fixed shapes x {sizes['val_points']} "
              f"points: val_seg_iou {ep['val_seg_iou']!r} val_res_loss "
              f"{ep['val_res_loss']!r}; {s:.1f} s", flush=True)
        check(all(np.isfinite(v) for st in res.steps for v in st.values())
              and all(st["grad_ok"] == 1.0 for st in res.steps)
              and np.isfinite(ep["val_seg_iou"]),
              f"fine-tune run {i}: finite, grad_ok 1 at every step")
        return res, step_ms, s

    res, step_ms, _ = run(1)
    res2, _, _ = run(2)
    out["step_ms"], out["epochs"] = step_ms, res.epochs
    check(res.steps == res2.steps and res.epochs == res2.epochs,
          "fine-tune twice from one seed: every step's metrics and the "
          "validation equal")
    ckpt = os.path.join(conf.log_dir, "checkpoints", f"{conf.model_path}.npz")
    flat, mine = load_npz_params(ckpt), params_to_jax(res2.model)
    check(sorted(flat) == sorted(mine)
          and all(np.array_equal(flat[k], mine[k]) for k in flat),
          f"the checkpoint {conf.model_path}.npz loads back bit for bit")
    # the fixed validation sample rebuilt, scored by a standalone eval_step
    # of the trained network
    eval_step = te2e.make_e2e_step(res2.model, spline_fit, make_optimizer(
        res2.model.parameters(), "adam", conf.lr))[1]
    sample = validation_sample(
        val_gen(), validation_batches(n_val, conf.batch_size), conf.seed,
        lambda *b: pack_batch(*b, sizes["val_points"], True, dev),
        lambda x, g: (te2e.draw_e2e(x.shape[0], x.shape[1],
                                    te2e.MS_NUM_SAMPLES, g, dev),), dev)
    alone = mean_metrics([eval_step(*vb) for vb in sample])[1]
    ep = res2.epochs[0]
    print(f"[10 finetune] standalone eval_step on the {n_val} x "
          f"{sample[0][0].shape[1]} sample: seg_iou {alone['seg_iou']!r} "
          f"res_loss {alone['res_loss']!r}", flush=True)
    check(sample[0][0].shape[1] == sizes["val_points"]
          and alone["seg_iou"] == ep["val_seg_iou"]
          and alone["res_loss"] == ep["val_res_loss"],
          f"val_seg_iou / val_res_loss at {sizes['val_points']} points equal "
          "the standalone eval_step's bit for bit")

    # (b) cli.export_params of that checkpoint
    cand = os.path.join(work, "cand_e2e.npz")
    check(cexport.export(ckpt, cand), "export_params wrote the candidate")
    with np.load(cand) as z:
        kinds = {str(z[k].dtype) for k in z.files if k.startswith("params")}
        rest = {str(z[k].dtype) for k in z.files
                if not k.startswith("params")}
    check(kinds == {"float16"} and rest <= {"float32"},
          f"export dtypes: params {sorted(kinds)}, others {sorted(rest)}")

    # (c) the gate over three cli.bench runs at the full protocol
    recs = {}
    with contextlib.chdir(REPO):
        for tag, env in (("cand_a", {"BENCH_PARAMS": cand}),
                         ("cand_b", {"BENCH_PARAMS": cand,
                                     "BENCH_STREAM": "b"}),
                         ("shipped_b", {"BENCH_STREAM": "b"}),
                         ("shipped_a", {})):
            if tag == "shipped_a" and bench_a is not None:
                recs[tag] = bench_a
                continue
            recs[tag] = cbench.run(cbench.settings(
                {**env, **sizes["bench_env"]}), dev)
            d = recs[tag]["detail"]
            print(f"[10 gate] {tag}: {d['per_shape_ms']:.2f} ms a shape, "
                  f"seg_iou {d['seg_iou']:.5f} sk_2 {d['sk_2']:.5f} residual "
                  f"{d['residual']:.5f}, floors applied "
                  f"{d['floors_applied']}, quality_ok {d['quality_ok']}, "
                  f"params {d['params_src']}", flush=True)
            check(all(np.isfinite(d[k]) for k in ("seg_iou", "sk_2",
                                                   "residual")),
                  f"gate run {tag}: finite metrics")
    out["gate_runs"] = {k: v["detail"] for k, v in recs.items()}
    check(recs["cand_a"]["detail"]["params_src"] == cand
          and recs["cand_a"]["detail"]["trained_params"],
          "cli.bench loaded the export")
    code, text = run_gate(recs, cand, work)
    for line in text.splitlines():
        print(f"  {line}", flush=True)
    out["gate_exit"] = code
    print(f"[10 gate] verdict: exit {code} ("
          f"{ {0: 'promoted into the temporary params', 1: 'gate failed'}.get(code, 'inputs missing')})",
          flush=True)
    check(code in (0, 1), "the gate decided (exit 0 or 1)")
    check(params_digest() == before, "params/ untouched by the phase")

    # (d) validate_reference's table on stream-a shapes, in memory
    sl = sizes["proto"]
    pts, nrm, lab, prim = (a[sl] for a in shapes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    agg = cval.validate_split(model, pts, nrm, lab, prim, spline_fit,
                              generator=gen, device=dev)
    v_s = time.perf_counter() - t0
    with open(cval.EXPECTED) as f:
        summary = cval.parity_table(agg, json.load(f))
    out["validate"] = summary
    check(all(np.isfinite(r["measured"]) for r in summary["rows"])
          and summary["n_shapes"] == len(pts),
          f"validate_reference table on {len(pts)} stream-a shapes finite "
          f"({1000.0 * v_s / len(pts):.1f} ms a shape)")
    gen.manual_seed(0)
    same = True
    for b in range(0, len(pts), 4):
        p = tp.predict_segmentation(model, pts[b:b + 4], nrm[b:b + 4],
                                    lab[b:b + 4], prim[b:b + 4],
                                    generator=gen, device=dev)
        same &= np.array_equal(p.labels.cpu().numpy(),
                               agg["seg_id"][b:b + 4])
    check(same, "validate_reference's labels equal predict_segmentation's "
          "bit for bit")
    import importlib.util
    if importlib.util.find_spec("h5py") is not None:
        import h5py
        data = os.path.join(work, "shapes")
        os.makedirs(data)
        for split in ("val", "test"):
            with h5py.File(os.path.join(data, f"{split}_data.h5"), "w") as f:
                for k, a in zip(("points", "normals", "labels", "prim"),
                                (pts, nrm, lab, prim)):
                    f.create_dataset(k, data=a)
        cfg_path = os.path.join(work, "validate.yml")
        with open(cfg_path, "w") as f:
            f.write(f'[train]\nmodel_path = "parsenet_e2e"\ndataset = '
                    f'"{data}/"\nlog_dir = "{work}/vlogs"\nnormals = True\n'
                    f"num_val = {len(pts)}\nnum_test = {len(pts)}\nmode = 5\n"
                    "knn_k = 80\n")
        s5 = cval.main([cfg_path, "--params", PARAMS, "--device", str(dev)])
        check(all(np.isfinite(r["measured"]) for r in s5["rows"]),
              "validate_reference through h5 files: finite")
    else:
        print("[10 validate] h5py absent: the table in memory only",
              flush=True)
    shutil.rmtree(work, ignore_errors=True)
    out["launches"] = dict(kernels.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[10] {out['seconds']:.1f} s, launches K1 f32 "
          f"{out['launches']['K1']}, K1 bf16 {out['launches']['K1tc']}, K2 "
          f"{out['launches']['K2']}, K3 {out['launches']['K3']}, K4 "
          f"{out['launches']['K4']}", flush=True)
    for kname in ("K1", "K1tc", "K2", "K3", "K4"):
        check(out["launches"][kname] > 0,
              f"phase 10 launched {kname} ({out['launches'][kname]})")
    return out


def k2_checks(kernels, hg, costs, what, key, max_iter=3000):
    """Both K2 entries on the cost matrices [B, n, n] in one batched call
    each, against their plain versions: lap_assign (the whole solve_lap)
    and auction_assign (on lap_benefit's benefit) must give the plain
    assignments exactly, and every completed assignment must be a
    permutation. Returns the checks and the persons left for the rank
    fill, under keys ending in `key`."""
    import torch
    n = costs.shape[-1]
    args = (hg._EPS0, hg._ESC_EVERY, hg._ESC, max_iter)
    benefit = hg.lap_benefit(costs)
    perm_k = kernels.lap_assign(costs, *args)
    a_k = kernels.auction_assign(benefit, *args)
    same_lap = bool(torch.equal(perm_k,
                                kernels.lap_assign_plain(costs, *args)))
    same_ben = bool(torch.equal(a_k, kernels.auction_assign_plain(benefit,
                                                                  *args)))
    perms = all(sorted(r.tolist()) == list(range(n)) for r in perm_k)
    left = int((a_k < 0).sum())
    check(same_lap, f"K2 lap_assign identical to lap_assign_plain on {what}")
    check(same_ben, f"K2 auction_assign identical to auction_assign_plain "
          f"on {what} ({left} persons left for the rank fill)")
    check(perms, f"K2 every completed assignment of {what} is a permutation")
    return {f"K2{key}_identical": same_lap and same_ben,
            f"K2{key}_permutations": perms, f"K2{key}_rank_fill": left}


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
    from parsenet_tpu_torch.fitting.spline_apply import (build_spline_fit,
                                                         trained_spline_fit)
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
        # per kernel: the fixed-count one keeps the count it had before the
        # early exit was added beside it; the exit (ms_exit_kernel) has some
        for kname, src, fixed in (("K1tc", "ms_iterations_tc.cu", 24),
                                  ("K1", "ms_iterations_tf32.cu", 60)):
            by_fn = sass_count_by_function(kernels._lib_path(kname), "HGMMA")
            tol0 = sum(v for f, v in by_fn.items()
                       if "ms_tc_kernel" in f or "ms_tf32_kernel" in f)
            exit_ = sum(v for f, v in by_fn.items() if "ms_exit_kernel" in f)
            report[f"{kname}_hgmma"] = tol0
            report[f"{kname}_exit_hgmma"] = exit_
            check(tol0 == fixed, f"{src} fixed-count kernel: {tol0} HGMMA "
                  f"(wgmma) instructions, as before ({fixed})")
            check(exit_ > 0, f"{src} early-exit kernel: {exit_} HGMMA")
            log = kernels.BUILD_LOG.get(kname, "")
            spills = [ln.strip() for ln in log.splitlines()
                      if re.search(r"[1-9]\d* bytes spill", ln)]
            serialized = sorted(set(re.findall(r"\(C751\d\)", log)))
            report[f"{kname}_ptxas"] = {"spills": spills,
                                        "serialized": serialized}
            check(not spills and not serialized,
                  f"{src}: no spills and no C751x \"wgmma serialized\" note "
                  f"from ptxas ({spills}, {serialized})")

    phase(wgmma_in_sass)

    def k3_sass():
        # K3's scan loop: 3 FFMA a (target, query) pair, so pairs = FFMA / 3
        for r in (4, 8):
            stats = sass_loop(kernels._lib_path("K3"),
                              f"min_sqdist_kernelILi{r}E")
            report[f"K3_sass_loop_r{r}"] = stats
            if not check(stats is not None and stats[1] > 0,
                         f"K3 (R = {r}) scan loop found in the SASS"):
                continue
            n_ins, ffma, lds = stats
            print(f"  K3 R = {r} scan loop: {n_ins} instructions, {ffma} "
                  f"FFMA, {lds} LDS: {3.0 * n_ins / ffma:.2f} instructions "
                  "a pair", flush=True)

    phase(k3_sass)

    # ---- shared inputs: stream a exactly as bench.py builds it
    n_batch, warmup, iters, n_pts = 4, 2, 8, 10000
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(7), (warmup + iters) * n_batch, n_pts)
    # phase 4d's 8 shapes as an ABC h5 holds them (before normalize_points)
    proto = slice(warmup * n_batch, (warmup + 2) * n_batch)
    proto_raw = (pts[proto].astype(np.float32),
                 normals[proto].astype(np.float32))
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
    # 8 stream-a embeddings, each at its own bandwidth (phases 3 and 6)
    gen_e = torch.Generator(device=dev)   # leaves `gen` to the slice
    gen_e.manual_seed(3)
    emb8 = []
    for i in range(8):
        with torch.no_grad():
            e = model(torch.from_numpy(np.concatenate(
                [pts[i:i + 1], normals[i:i + 1]], -1)).to(dev))[0][0]
        e = (e / (torch.linalg.norm(e, dim=-1, keepdim=True)
                  + 1e-12)).contiguous()
        emb8.append((e, ms._initial_bandwidth(
            ms._subset_sqdist(e, 5000, generator=gen_e), 0.015)))

    # K1 exit's sets (phases 3 and 6): the stream-a embedding and clustered
    # rows at N = 100 to 20,000 (157 row blocks, more than the SMs), D = 64
    # and 128. The 20,000 rows are drawn tighter (noise 0.05): at 0.08 so
    # many rows sit between modes that even the fixed-count kernels end
    # beyond the limits that hold an exit to the plain version after 50
    # iterations
    exit_sets = [(f"stream a {embn.shape[0]} x {embn.shape[1]}", embn, bw)]
    rng_x = np.random.RandomState(0)
    for n_c, d_c, noise in ((100, 128, 0.08), (1000, 64, 0.08),
                            (4999, 128, 0.08), (10000, 128, 0.08),
                            (20000, 128, 0.05)):
        if n_c == 20000:    # the same draw at 0.08, for phase 3's reading
            rng_08 = np.random.RandomState()
            rng_08.set_state(rng_x.get_state())
        exit_sets.append((f"clustered {n_c} x {d_c}", torch.from_numpy(
            clustered(rng_x, n_c, d_c, noise=noise)).to(dev), 0.2))
    x08 = torch.from_numpy(clustered(rng_08, 20000, 128)).to(dev)

    # ---- 3. kernels against their plain versions
    def kernel_checks():
        print(f"[3 kernel vs plain] K1 bandwidth {float(bw):.6f}; K1tc "
              f"(grid, slots) {kernels.ms_plan(embn.shape[0], sms)}",
              flush=True)
        # K1 f32 (3xTF32 tensor-core kernel) against the plain f32
        # version, on ms_plan's grid (every SM, partial sums exchanged) and
        # on one block per 128-row block (no exchange): max |d| after 1
        # iteration <= K1F_TOL_1, after 50 <= K1F_TOL_50; the same NMS
        # clustering (cluster numbering aside) on shape 0
        def k1f(x, b, it, one_block):
            if not one_block:
                return kernels.mean_shift_iterations(x, b, it)
            return kernels._ms_iterations_tf32(
                x, x, kernels._inv2b2(b, dev), it,
                -(-x.shape[0] // kernels.MS_BLOCK_ROWS))[:, :x.shape[1]]

        def k1f_checks(tag, x, b, one_block, its=(1, 50)):
            grid = "one block per 128 rows" if one_block else "ms_plan grid"
            errs = {}
            for it in its:
                k_out = k1f(x, b, it, one_block)
                p_out = kernels.mean_shift_iterations_plain(x, b, it)
                errs[it] = float((k_out - p_out).abs().max())
                tol = K1F_TOL_1 if it == 1 else K1F_TOL_50
                check(errs[it] <= tol, f"K1 f32 {tag}, {grid}, {it} it: "
                      f"max |d| {errs[it]:.3e} <= {tol:g}")
            return errs, k_out, p_out

        print(f"  K1 f32 (grid, slots) "
              f"{kernels.ms_plan(embn.shape[0], sms, kernels.MS_TF32_TILE)}",
              flush=True)
        x_tag = f"stream a {embn.shape[0]} x {embn.shape[1]}"
        for one_block in (False, True):
            errs, k_out, p_out = k1f_checks(x_tag, embn, bw, one_block)
            k_lab = ms.nms(k_out, embn, bw)[1].cpu().numpy()
            p_lab = ms.nms(p_out, embn, bw)[1].cpu().numpy()
            key = "K1_f32_one_block" if one_block else "K1_f32"
            report[f"{key}_max_abs_err"] = errs[50]
            report[f"{key}_max_abs_err_1"] = errs[1]
            check(np.array_equal(canonical(k_lab), canonical(p_lab)),
                  f"K1 f32 {x_tag}, "
                  f"{'one block per 128 rows' if one_block else 'ms_plan grid'}"
                  f": NMS clustering identical ({k_lab.max() + 1} clusters)")
        # the e2e trainer's escalation attempts: 8,000 x 128 for 5
        # iterations (another grid and exchange split, the last row block
        # half full), at stream a's bandwidth and at the e2e loss's
        # (quantile 0.025 of a 2,048-row subset); 5 iterations are held to
        # K1F_TOL_50, the NMS clustering must be identical
        x8 = embn[:8000].contiguous()
        g8 = torch.Generator(device=dev)
        g8.manual_seed(8)
        bw8 = ms._initial_bandwidth(ms._subset_sqdist(x8, 2048,
                                                      generator=g8), 0.025)
        print(f"  K1 f32 at 8000 x 128 (grid, slots) "
              f"{kernels.ms_plan(8000, sms, kernels.MS_TF32_TILE)}; "
              f"bandwidths {float(bw):.6f}, {float(bw8):.6f}", flush=True)
        e2e_err = {}
        for b8 in (bw, bw8):
            for one_block in (False, True):
                x_tag = f"e2e attempts 8000 x 128 at bw {float(b8):.4f}"
                errs, k_out, p_out = k1f_checks(x_tag, x8, b8, one_block,
                                                its=(1, 5))
                for it, e in errs.items():
                    e2e_err[it] = max(e2e_err.get(it, 0.0), e)
                k_lab = ms.nms(k_out, x8, b8)[1].cpu().numpy()
                p_lab = ms.nms(p_out, x8, b8)[1].cpu().numpy()
                grid = "one block per 128 rows" if one_block else "ms_plan"
                check(np.array_equal(canonical(k_lab), canonical(p_lab)),
                      f"K1 f32 {x_tag}, {grid}, 5 it: NMS clustering "
                      f"identical ({k_lab.max() + 1} clusters)")
        report["K1_f32_e2e_max_abs_err"] = e2e_err[5]
        report["K1_f32_e2e_max_abs_err_1"] = e2e_err[1]
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
        # bandwidth 0.2, both grids, both tensor-core kernels
        rng_c = np.random.RandomState(0)
        for n_c, d_c in ((100, 128), (1000, 64), (4999, 128)):
            xc = torch.from_numpy(clustered(rng_c, n_c, d_c)).to(dev)
            for one_block in (False, True):
                k1tc_checks(f"clustered {n_c} x {d_c}", xc, 0.2, one_block)
                k1f_checks(f"clustered {n_c} x {d_c}", xc, 0.2, one_block)

        # both tensor-core K1s on 8 stream-a embeddings at their own
        # bandwidth
        gen_p = torch.Generator(device=dev)   # the key orders
        gen_p.manual_seed(11)
        agrees, errs, bf16_vs_f32 = [], [], []
        f_agrees, f_errs, f_floor = [], [], []
        for i, (e, b) in enumerate(emb8):
            err, k_out, p_out = k1tc_checks(f"stream-a embedding {i}", e, b,
                                            False, its=(50,))
            p_lab = ms.nms(p_out, e, b)[1].cpu().numpy()
            errs.append(err[50])
            agrees.append(co_membership(ms.nms(k_out, e, b)[1].cpu().numpy(),
                                        p_lab))
            # the scale of NMS's own sensitivity: plain bf16 against f32
            err, k_out, p_out = k1f_checks(f"stream-a embedding {i}", e, b,
                                           False, its=(50,))
            f32_lab = ms.nms(p_out, e, b)[1].cpu().numpy()
            bf16_vs_f32.append(co_membership(p_lab, f32_lab))
            # the 3xTF32 K1 against plain f32, beside NMS's own sensitivity
            # at f32: plain f32 with the keys in another order (the same
            # sums, rounded in another order) against plain f32
            f_errs.append(err[50])
            f_agrees.append(co_membership(
                ms.nms(k_out, e, b)[1].cpu().numpy(), f32_lab))
            perm = torch.randperm(e.shape[0], device=dev, generator=gen_p)
            reordered = kernels.mean_shift_iterations_plain(
                e[perm].contiguous(), b, 50)[torch.argsort(perm)]
            f_floor.append(co_membership(
                ms.nms(reordered, e, b)[1].cpu().numpy(), f32_lab))
        report["K1tc_co_membership_8"] = agrees
        report["K1tc_max_abs_err_8"] = errs
        report["K1_f32_co_membership_8"] = f_agrees
        report["K1_f32_max_abs_err_8"] = f_errs
        report["plain_f32_reordered_co_membership_8"] = f_floor
        print("  (plain f32 with the keys reordered against plain f32, "
              "co-membership: " + ", ".join(f"{v:.6f}" for v in f_floor)
              + ")")
        check(all(a >= min(K1F_AGREE, f) for a, f in zip(f_agrees, f_floor)),
              f"K1 f32 co-membership on 8 stream-a embeddings >= "
              f"{K1F_AGREE}, or where NMS itself moves more than that at "
              "f32, >= the reordered plain version's (each: " + ", ".join(
                  f"{v:.6f}" for v in f_agrees) + ")")
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
        report.update(k2_checks(kernels, hg, torch.stack(costs), "16 "
                                "matrices (8 SIOU-structured, 8 random)",
                                ""))
        # ragged sizes with exact ties (costs in quarters), and a round cap
        # that leaves persons to the rank fill
        rng_k2 = np.random.RandomState(1)
        for n_r in (1, 8, 33, 64):
            c_r = torch.from_numpy((rng_k2.randint(0, 3, (4, n_r, n_r)) / 4)
                                   .astype(np.float32)).to(dev)
            report.update(k2_checks(kernels, hg, c_r, f"4 tied {n_r} x {n_r} "
                                    "matrices", f"_n{n_r}"))
        left = k2_checks(kernels, hg, torch.stack(costs[8:]), "8 random "
                         "50 x 50 matrices capped at 5 rounds", "_cap5",
                         max_iter=5)
        report.update(left)
        check(left["K2_cap5_rank_fill"] > 0, "K2 at 5 rounds leaves persons "
              "to the rank fill")

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

        # K3 on exact ties: integer coordinates (every squared distance
        # exact in f32, in any order of operations), every target twice,
        # shuffled: d and the first index of the minimum equal everywhere
        def grid_pts(*shape):
            return torch.randint(-6, 7, shape, device=dev,
                                 generator=gen_k).float()

        def dup(x):
            perm = torch.randperm(2 * x.shape[-2], device=dev,
                                  generator=gen_k)
            return torch.cat([x, x], -2)[..., perm, :].contiguous()

        for b, n_t, m_t in ((1, 10000, 5000), (1, 204800, 1250),
                            (36, 700, 800)):
            qq, xx = grid_pts(b, n_t, 3), dup(grid_pts(b, m_t, 3))
            d_k, i_k2 = kernels.min_sqdist_with_idx(qq, xx)
            d_p, i_p2 = kernels.min_sqdist_with_idx_plain(qq, xx)
            check(bool(torch.equal(d_k, d_p))
                  and bool(torch.equal(i_k2, i_p2)),
                  f"K3 exact ties {b} x ({n_t} vs {m_t} twice) (plan "
                  f"{kernels.min_sqdist_plan(b, n_t, 2 * m_t, sms)}): d and "
                  f"indices equal everywhere ({int((i_k2 != i_p2).sum())} "
                  "indices differ)")

        # K3 at ragged sizes, with masks, and a batch whose patch 2 has
        # every target masked (1e30 and index 0 there)
        ragged = [(1, 1, 1), (2, 63, 65), (3, 65, 1601), (2, 1601, 63),
                  (1, 1601, 1601), (4, 700, 1600)]
        for b, n_r, m_r in ragged:
            qq = torch.randn(b, n_r, 3, device=dev, generator=gen_k)
            xx = torch.randn(b, m_r, 3, device=dev, generator=gen_k)
            mk = (torch.rand(b, m_r, device=dev, generator=gen_k)
                  < 0.8).float()
            mk[:, 0] = 1.0
            if b == 4:
                mk[2] = 0.0
            d_k, i_k2 = kernels.min_sqdist_with_idx(qq, xx, mk)
            d_p, i_p2 = kernels.min_sqdist_with_idx_plain(qq, xx, mk)
            live = [p for p in range(b) if p != 2 or b != 4]
            err = (d_k - d_p).abs()[live]
            uniq = torch.stack([unique_min_mask(qq[p], xx[p][mk[p] > 0])
                                for p in live])
            check(bool((err <= 1e-6 + 1e-5 * d_p.abs()[live]).all())
                  and bool((i_k2[live] == i_p2[live])[uniq].all()),
                  f"K3 ragged {b} x ({n_r} vs {m_r}) masked (plan "
                  f"{kernels.min_sqdist_plan(b, n_r, m_r, sms)}): max |d| "
                  f"{float(err.max()):.3e} within 1e-6 + 1e-5 |ref|, indices "
                  f"equal on {int(uniq.sum())}/{uniq.numel()} unique minima")
            if b == 4:
                check(bool((d_k[2] == kernels.MIN_SQDIST_BIG).all())
                      and bool((i_k2[2] == 0).all()),
                      "K3 fully masked patch: 1e30 and index 0")

        # K4 on K3's argmins against the plain version (gather, and the
        # scatter of -dq in ascending query order): dq and dx bitwise, and
        # dx the same in a second call; at the training shape, with every
        # query on one of 8 targets a patch (long chains), and at 40,000
        # targets a patch, more than one shared-memory chunk, with the
        # query entries in device memory
        xw = torch.rand(2, 40000, 3, device=dev, generator=gen_k)
        qw = (xw[:, torch.randint(0, 40000, (30000,), device=dev,
                                  generator=gen_k)]
              + 0.003 * torch.randn(2, 30000, 3, device=dev,
                                    generator=gen_k)).contiguous()
        gw = torch.rand(2, 30000, device=dev, generator=gen_k)
        few = torch.randint(0, 8, tq.shape[:2], device=dev, generator=gen_k)
        k4_err = 0.0
        for k4_tag, qq, xx, ii, gg in (
                (tag, tq, tx, i_k, g_k4),
                (f"{tag}, every query on one of 8 targets", tq, tx,
                 few.to(torch.int32), g_k4),
                ("2 x (30,000 vs 40,000)", qw, xw,
                 kernels.min_sqdist_with_idx(qw, xw)[1], gw)):
            dq_k, dx_k = kernels.min_sqdist_bwd(qq, xx, ii, gg)
            dq_p, dx_p = kernels.min_sqdist_bwd_plain(qq, xx, ii, gg)
            k4_err = max(k4_err, float((dq_k - dq_p).abs().max()),
                         float((dx_k - dx_p).abs().max()))
            shared = int(ii.numel() - sum(int(torch.unique(r).numel())
                                          for r in ii))
            check(bool(torch.equal(dq_k, dq_p)),
                  f"K4 {k4_tag}: dq bitwise equal to plain")
            check(bool(torch.equal(dx_k, dx_p)) and bool(torch.equal(
                dx_k, kernels.min_sqdist_bwd(qq, xx, ii, gg)[1])),
                  f"K4 {k4_tag}: dx bitwise equal to plain and in a second "
                  f"call (max |d| {float((dx_k - dx_p).abs().max()):.3e}; "
                  f"{shared} queries add into a target another query "
                  "picked)")
        report["K4_max_abs_err"] = k4_err
        dq_k, dx_k = kernels.min_sqdist_bwd(tq, tx, i_k, g_k4)
        qg, xg = tq.clone().requires_grad_(), tx.clone().requires_grad_()
        (kernels.MinSqdist.apply(qg, xg) * g_k4).sum().backward()
        check(bool(torch.equal(qg.grad, dq_k)) and float(qg.grad.abs().max())
              > 0 and bool(torch.equal(xg.grad, dx_k)),
              "MinSqdist gradients on the card are K4's and nonzero")

        # K5: one step of perturbed queries against the embedding, on
        # ms_plan's grid and on one block per 128 query rows, and of
        # ragged queries against more or fewer keys
        k5_cases = [("10,000 x 128, m != x", m5, embn)]
        rng_5 = np.random.RandomState(5)
        for nq, nk in ((300, 1000), (1000, 300)):
            k5_cases.append((f"{nq} queries vs {nk} keys x 64",
                             torch.from_numpy(clustered(rng_5, nq, 64)).to(dev),
                             torch.from_numpy(clustered(rng_5, nk, 64)).to(dev)))
        k5_err = 0.0
        for tag, mq, xk in k5_cases:
            inv = 1.0 / (2.0 * 0.2 * 0.2) if mq is not m5 else inv2b2
            p_out = kernels.mean_shift_step_plain(mq, xk, inv)
            one = kernels._ms_iterations_tf32(
                mq, xk, torch.tensor([float(inv)], device=dev), 1,
                -(-mq.shape[0] // kernels.MS_BLOCK_ROWS), "K5")
            for grid, k_out in (
                    ("ms_plan grid", kernels.mean_shift_step(mq, xk, inv)),
                    ("one block per 128 rows", one[:, :mq.shape[1]])):
                err = float((k_out - p_out).abs().max())
                k5_err = max(k5_err, err)
                check(err <= K1F_TOL_1, f"K5 {tag}, {grid}: max |d| "
                      f"{err:.3e} <= {K1F_TOL_1:g}")
        report["K5_max_abs_err"] = k5_err

        # K1 exit (tol > 0), both modes, on every SM and on EXIT_SMALL_GRID
        # blocks (each holding several row blocks), at tol 1e-6 and at
        # EXIT_TOL_COARSE, where leaving early moves m by far more than the
        # limits: two launches equal bit for bit; each row block's
        # iterations and m held to the rule on the kernel's own trajectory
        # (exit_check, exactly), whose first iteration is, in bf16, the
        # fixed-count kernel's bit for bit where both split alike; m within
        # the 50-iteration limit of the plain version at exit_rows = 128,
        # and its iterations equal to the plain version's but where both
        # deltas at the first disputed iteration lie within the mode's
        # EXIT_BAND of tol (f32: and one iteration apart at most); at tol
        # 1e-6, m within 1e-4 (f32) and 1e-2 (bf16) of the kernel's tol = 0
        # run. Every launch runs under the watchdog.
        exit_err = {True: 0.0, False: 0.0}
        coarse_moved = {True: 0.0, False: 0.0}
        for tag, x, b in exit_sets:
            for bf16 in (True, False):
                mode = "bf16" if bf16 else "f32"
                lim = K1TC_TOL_50 if bf16 else K1F_TOL_50
                band = EXIT_BAND[mode]
                k_0 = k1_launch(kernels, x, b, bf16, 50)
                for tol in (EXIT_TOL, EXIT_TOL_COARSE):
                    plain = kernels.mean_shift_iterations_plain(
                        x, b, 50, bf16_dots=bf16, tol=tol,
                        exit_rows=kernels.MS_BLOCK_ROWS)
                    for grid in (None, EXIT_SMALL_GRID):
                        gtag = ("every SM" if grid is None
                                else f"{grid} blocks")
                        c = exit_check(kernels, x, b, bf16, grid, tol)
                        err = float((c["out"] - plain).abs().max())
                        err0 = float((c["out"] - k_0).abs().max())
                        exit_err[bf16] = max(exit_err[bf16], err)
                        name = f"K1 exit {mode} {tag}, {gtag}, tol {tol:g}"
                        share = np.mean(c["kernel"]) / 50
                        report.setdefault("K1_exit_checks", []).append({
                            "case": name, "iterations": c["kernel"],
                            "plain_iterations": c["plain"],
                            "plain_diff": c["plain_diff"],
                            "live_per_iteration": c["live"],
                            "repeat": c["repeat"],
                            "first_iteration_fixed": c["first_fixed"],
                            "max_abs_err": err, "tol0_max_abs_err": err0})
                        check(c["repeat"], f"{name}: two launches equal bit "
                              "for bit (m and iterations)")
                        if c["first_fixed"] is not None:
                            check(c["first_fixed"], f"{name}: its first "
                                  "iteration is the fixed-count kernel's "
                                  "bit for bit (one split)")
                        check(c["rule_ok"] and c["max_abs_err_m"] == 0.0,
                              f"{name}: every row block's iterations and m "
                              f"follow the rule on the kernel's own "
                              f"trajectory (m off by {c['max_abs_err_m']:g}"
                              f"; {100.0 * share:.1f}% of the 50 "
                              "iterations)")
                        excused = [
                            d for d in c["plain_diff"]
                            if (bf16 or abs(d[1] - d[2]) == 1)
                            and d[3] is not None
                            and abs(d[3] - tol) <= band
                            and abs(d[4] - tol) <= band]
                        check(len(excused) == len(c["plain_diff"]),
                              f"{name}: iterations equal to the plain "
                              f"version's in {len(c['kernel']) - len(excused)}"
                              f" of {len(c['kernel'])} row blocks, the rest "
                              f"within {band:g} of tol at the first "
                              "disputed iteration ((block, kernel, plain, "
                              "kernel delta, plain delta): "
                              + ", ".join(f"({d[0]}, {d[1]}, {d[2]}, "
                                          f"{d[3]:.3g}, {d[4]:.3g})"
                                          for d in c["plain_diff"][:8])
                              + ")")
                        if tol == EXIT_TOL:
                            lim0 = 1e-2 if bf16 else 1e-4
                            check(err <= lim and err0 <= lim0,
                                  f"{name}: max |d| {err:.3e} <= {lim:g} "
                                  f"from plain, {err0:.3e} <= {lim0:g} "
                                  "from tol = 0")
                        else:
                            coarse_moved[bf16] = max(coarse_moved[bf16],
                                                     err0)
                            check(err <= lim, f"{name}: max |d| {err:.3e} "
                                  f"<= {lim:g} from plain ({err0:.3e} from "
                                  "tol = 0)")
        for bf16 in (True, False):
            lim = K1TC_TOL_50 if bf16 else K1F_TOL_50
            check(coarse_moved[bf16] > lim,
                  f"K1 exit {'bf16' if bf16 else 'f32'}, tol "
                  f"{EXIT_TOL_COARSE:g}: leaving early moves m by up to "
                  f"{coarse_moved[bf16]:.3e} from the tol = 0 run, more "
                  f"than the {lim:g} held to the plain version")
        # with no row block leaving (tol 1e-30), the bf16 exit's work split
        # stays ms_plan's at 10,000 rows: its first 5 iterations must be the
        # fixed-count kernel's bit for bit (the same arithmetic)
        same = all(bool(torch.equal(
            k1_launch(kernels, embn, bw, True, j, 1e-30),
            k1_launch(kernels, embn, bw, True, j))) for j in range(1, 6))
        check(same, "K1 exit bf16, nothing leaving: iterations 1-5 the "
              "fixed-count kernel's bit for bit")
        # the f32 exit adds its tiles in chains of EXIT_CHAIN, so that the
        # split moves m by less than EXIT_BAND: with nothing leaving, one
        # iteration's m on every SM, 33 and 8 blocks must agree within
        # EXIT_BAND["f32"] on the stream-a embedding and the clustered
        # 10,000 rows (after 3, a reading: the iterations also carry the
        # first one's differences on). Beside it, the spread of the
        # fixed-count kernel over splits, whose chains span a grid block's
        # whole run: one step of one 128-row block (K5) shared by 1 to 39
        # blocks
        x10 = [x for t_, x, _ in exit_sets if x.shape[0] == 10000
               and t_.startswith("clustered")][0]
        spread = {}
        for tag, x, b in ((exit_sets[0][0], embn, bw),
                          ("clustered 10000 x 128", x10, 0.2)):
            for j in (1, 3):
                outs = [k1_launch(kernels, x, b, False, j, 1e-30, None, g)
                        for g in (None, EXIT_SMALL_GRID, 8)]
                spread[f"{tag}, {j}"] = max(
                    float((u - v).abs().max()) for u in outs for v in outs)
        check(max(v for k, v in spread.items() if k.endswith(", 1"))
              <= EXIT_BAND["f32"],
              "K1 exit f32, nothing leaving: one iteration's m on every SM, "
              f"33 and 8 blocks within {EXIT_BAND['f32']:g} of each other ("
              + ", ".join(f"{k} iterations {v:.3g}"
                          for k, v in spread.items()) + ")")
        inv10 = kernels._inv2b2(0.2, dev)
        q10 = kernels.mean_shift_iterations_plain(x10, 0.2, 8)[:128]
        fixed = [kernels._ms_iterations_tf32(q10, x10, inv10, 1, g, "K5")
                 for g in (1, 2, 8, 39)]
        p10 = kernels.mean_shift_step_plain(q10, x10, inv10)
        report["K1_exit_f32_split_spread"] = spread
        report["K5_split_spread"] = {
            "spread": max(float((u - v).abs().max()) for u in fixed
                          for v in fixed),
            "from_plain": [float((u - p10).abs().max()) for u in fixed]}
        print("  K5 (the fixed-count tf32 kernel) one step of a 128-row "
              "block of the clustered 10,000 rows (after 8 plain "
              "iterations) shared by 1, 2, 8, 39 blocks: max |d| from the "
              "plain version " + ", ".join(
                  f"{v:.3g}" for v in report["K5_split_spread"]["from_plain"])
              + f"; spread {report['K5_split_spread']['spread']:.3g}; the "
              "f32 exit's spread over its grids " + ", ".join(
                  f"{v:.3g}" for v in spread.values()), flush=True)
        # why the 20,000-row exit set is drawn at noise 0.05: the same draw
        # at 0.08, the fixed-count kernels' and the exits' (tol 1e-6, every
        # SM) distance from the plain version after 50 iterations (a
        # reading, beside the limits)
        far = {}
        for bf16 in (False, True):
            mode = "bf16" if bf16 else "f32"
            p50 = kernels.mean_shift_iterations_plain(x08, 0.2, 50,
                                                      bf16_dots=bf16)
            pe = kernels.mean_shift_iterations_plain(
                x08, 0.2, 50, bf16_dots=bf16, tol=EXIT_TOL,
                exit_rows=kernels.MS_BLOCK_ROWS)
            far[mode] = float((k1_launch(kernels, x08, 0.2, bf16, 50)
                               - p50).abs().max())
            far[f"{mode}_exit"] = float((k1_launch(
                kernels, x08, 0.2, bf16, 50, EXIT_TOL) - pe).abs().max())
        report["clustered_20000_noise_008_max_abs_err"] = far
        print("  clustered 20,000 x 128 at noise 0.08 (not an exit set), "
              "max |d| from plain after 50 iterations: fixed-count K1 f32 "
              f"{far['f32']:.3e}, K1 exit {far['f32_exit']:.3e} (limit "
              f"{K1F_TOL_50:g}); K1tc {far['bf16']:.3e}, K1tc exit "
              f"{far['bf16_exit']:.3e} (limit {K1TC_TOL_50:g})", flush=True)
        report["K1tc_exit_max_abs_err"] = exit_err[True]
        report["K1_exit_max_abs_err"] = exit_err[False]

    phase(kernel_checks)

    # ---- 3b. K3 and K4 at the e2e loss's shapes: the 4 spline slots'
    # chamfer (8,000 points of a shape against each slot's 900 surface
    # samples) and its masked reverse, slot 3's GT segment empty
    def e2e_kernel_checks():
        g3 = torch.Generator(device=dev)
        g3.manual_seed(6)
        p8 = torch.from_numpy(pts[0][:8000]).to(dev)
        seg8 = torch.from_numpy(labels[0][:8000]).to(dev)
        segs = torch.unique(seg8)[:4]
        surf = []
        for s_i in range(4):
            own = p8[seg8 == segs[s_i % segs.numel()]]
            pick = torch.randint(0, own.shape[0], (900,), device=dev,
                                 generator=g3)
            surf.append(own[pick] + 0.01 * torch.randn(
                900, 3, device=dev, generator=g3))
        xe = torch.stack(surf).contiguous()                  # [4, 900, 3]
        qe = p8.expand(4, 8000, 3).contiguous()
        on_seg = (seg8[None] == segs[:, None]).float()
        mask = on_seg.clone()
        mask[3] = 0.0
        e2e_shapes.update(q=qe, x=xe, on_seg=on_seg)
        for tag, qq, xx, mk in (
                ("slot chamfer 4 x (8,000 vs 900)", qe, xe, None),
                ("masked reverse 4 x (900 vs 8,000), slot 3 all masked", xe,
                 qe, mask)):
            d_k, i_k = kernels.min_sqdist_with_idx(qq, xx, mk)
            d_p, i_p = kernels.min_sqdist_with_idx_plain(qq, xx, mk)
            live = [b_ for b_ in range(4) if mk is None or b_ != 3]
            err = (d_k - d_p).abs()[live]
            uniq = torch.stack([unique_min_mask(
                qq[b_], xx[b_] if mk is None else xx[b_][mk[b_] > 0])
                for b_ in live])
            report[f"K3_e2e_{'masked' if mk is not None else 'slots'}"
                   "_max_abs_err"] = float(err.max())
            plan = kernels.min_sqdist_plan(4, qq.shape[1], xx.shape[1], sms)
            check(bool((err <= 1e-6 + 1e-5 * d_p.abs()[live]).all())
                  and bool((i_k[live] == i_p[live])[uniq].all()),
                  f"K3 {tag} (plan {plan}): max |d| "
                  f"{float(err.max()):.3e} within 1e-6 + 1e-5 |ref|, indices "
                  f"equal on {int(uniq.sum())}/{uniq.numel()} unique minima")
            if mk is not None:
                check(bool((d_k[3] == kernels.MIN_SQDIST_BIG).all())
                      and bool((i_k[3] == 0).all()),
                      "K3 masked reverse, slot 3: 1e30 and index 0")
            # K4 on these argmins, a random incoming gradient everywhere
            # (the fully masked slot too: dq and dx must stay finite there);
            # on the slot chamfer also the gradient the e2e loss gives it,
            # mean over the GT segment's points, 0 elsewhere (slot 3's
            # segment empty: 0 everywhere), which K4 leaves out of its sums
            grads = [("random gradient",
                      torch.rand(qq.shape[:2], device=dev, generator=g3))]
            if mk is None:
                grads.append(("the loss's masked gradient",
                              mask / (mask.sum(1, keepdim=True) + 1e-7)))
            for g_tag, gg in grads:
                dq_k, dx_k = kernels.min_sqdist_bwd(qq, xx, i_k, gg)
                dq_p, dx_p = kernels.min_sqdist_bwd_plain(qq, xx, i_k, gg)
                check(bool(torch.equal(dq_k, dq_p))
                      and bool(torch.equal(dx_k, dx_p))
                      and bool(torch.isfinite(dq_k).all())
                      and bool(torch.isfinite(dx_k).all()),
                      f"K4 {tag}, {g_tag}: dq and dx bitwise equal to "
                      "plain, finite")
        print(f"[3b e2e shapes] K3 and K4 at the slot chamfer's shapes "
              "checked", flush=True)

    e2e_shapes = {}
    phase(e2e_kernel_checks)

    # ---- 4. the slice: bench.py's configuration, with the spline slots,
    # then the spline-free path
    spline_fit = build_spline_fit(device=dev)

    def stream_a(n_timed, fit):
        """Warm-up and `n_timed` timed batches of stream a through run_batch
        -> (metric lists, seconds, stage ms a shape, launches)."""
        kernels.reset_launches()
        batches = [slice(b * n_batch, (b + 1) * n_batch)
                   for b in range(warmup + n_timed)]
        for s in batches[:warmup]:
            tp.run_batch(model, pts[s], normals[s], labels[s], prim[s], gen,
                         ms_bf16=True, spline_fit=fit, device=dev)
        timer = tp.StageTimer(True)
        metrics = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in batches[warmup:]:
            m = tp.run_batch(model, pts[s], normals[s], labels[s], prim[s],
                             gen, ms_bf16=True, spline_fit=fit, device=dev,
                             timer=timer)
            for k, v in m.items():
                metrics.setdefault(k, []).extend(v)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_shapes = n_timed * n_batch
        return (metrics, dt, {k: v / n_shapes for k, v in timer.ms().items()},
                dict(kernels.LAUNCHES))

    def report_arm(key, label, n_timed, metrics, dt, stage, launches, ref,
                   ref_name):
        n_shapes = n_timed * n_batch
        mean = {k: float(np.mean(v)) for k, v in metrics.items()}
        report[key] = {"metrics": mean, "per_shape": metrics,
                       "shapes_per_hour": n_shapes / dt * 3600.0,
                       "ms_per_shape": 1000.0 * dt / n_shapes,
                       "stage_ms_per_shape": stage, "launches": launches}
        print(f"[4 slice] {label}: {n_shapes} timed shapes: "
              f"{n_shapes / dt * 3600.0:.1f} shapes/hour, "
              f"{1000.0 * dt / n_shapes:.2f} ms/shape", flush=True)
        print("  quality: " + ", ".join(
            f"{k} {mean[k]:.5f}" + (f" ({ref_name} {ref[k]})" if k in ref
                                    else "")
            for k in ("seg_iou", "prim_iou", "residual", "p_cov", "sk_2")))
        print(f"  clusters per shape: mean {mean['num_clusters']:.2f}, max "
              f"{max(metrics['num_clusters'])}")
        print("  stage ms/shape: " + ", ".join(
            f"{k} {stage[k]:.3f}" for k in tp.STAGES if k in stage))
        print(f"  launches ({warmup + n_timed} batches): {launches}")
        check(mean["seg_iou"] >= floors["seg_iou_min"],
              f"{label} seg_iou {mean['seg_iou']:.4f} >= "
              f"{floors['seg_iou_min']}")
        check(mean["residual"] <= floors["residual_max"],
              f"{label} residual {mean['residual']:.5f} <= "
              f"{floors['residual_max']}")
        check(mean["sk_2"] >= floors["sk_2_min"],
              f"{label} sk_2 {mean['sk_2']:.4f} >= {floors['sk_2_min']}")
        for kname in ("K1tc", "K2", "K3"):
            check(launches[kname] > 0,
                  f"{label}: {kname} launched ({launches[kname]})")
        check(launches["K1"] == 0 and launches["K1tc_exit"] == 0,
              f"{label}: neither the f32 K1 nor an exit kernel launched "
              f"({launches['K1']}, {launches['K1tc_exit']})")
        check(all(np.isfinite(v) for v in mean.values()),
              f"{label} metrics finite")
        return mean

    floors = json.load(open(os.path.join(REPO, "configs",
                                         "quality_floors.json")))["bench"]

    siou_batch = {}   # the SIOU call of stream a's first timed batch
    cov_args = []     # the coverage call of its first shape

    def slice_run():
        # keep the arguments of the batch's one SIOU call, and of the first
        # timed shape's coverage (neither draws, so keeping them moves no
        # metric)
        siou, calls = tp.siou_matched_segments, []
        cover, cov_calls = tp.protocol_coverage, []

        def keep(*args, **kwargs):
            if len(calls) == warmup:
                siou_batch.update(args=args, kwargs=kwargs)
            calls.append(1)
            return siou(*args, **kwargs)

        def keep_cov(*args):
            if len(cov_calls) == warmup * n_batch:
                cov_args.extend(args)
            cov_calls.append(1)
            return cover(*args)
        tp.siou_matched_segments = keep
        tp.protocol_coverage = keep_cov
        gen_state = gen.get_state()
        try:
            out = stream_a(iters, spline_fit)
        finally:
            tp.siou_matched_segments = siou
            tp.protocol_coverage = cover
        report_arm("slice", "stream a, spline slots", iters, *out,
                   REFERENCE_FULL, "JAX full path")
        launches = out[3]
        shapes = (warmup + iters) * n_batch
        # per shape: the coverage trim, both coverage sides, the slot
        # residual (one batched call)
        check(launches["K3"] == 4 * shapes, f"K3 launched 4 times a shape, "
              f"the 12 slot residuals in one ({launches['K3']} for "
              f"{shapes} shapes)")
        # one SIOU call, so one K2 launch, a batch
        check(launches["K2"] == warmup + iters and len(calls) == warmup
              + iters, f"K2 launched once a batch ({launches['K2']} for "
              f"{warmup + iters} batches of {n_batch})")
        # the first timed batch: both K2 entries on its 4 matrices in one
        # call, and the batched SIOU against the one-shape calls, bitwise
        gt_b, lab_b, pp_b, gp_b, w_b = siou_batch["args"]
        costs = 1.0 - relaxed_iou(to_one_hot(lab_b), to_one_hot(gt_b))
        siou_batch["costs"] = costs.contiguous()
        report.update(k2_checks(kernels, hg, siou_batch["costs"],
                                f"stream a's first timed batch ({n_batch} "
                                "matrices)", "_stream_a"))
        seg, prim_i = siou(*siou_batch["args"], **siou_batch["kwargs"])
        one = [siou(gt_b[b], lab_b[b], pp_b[b], gp_b[b], w_b[b],
                    **siou_batch["kwargs"]) for b in range(n_batch)]
        same = all(torch.equal(seg[b], one[b][0])
                   and torch.equal(prim_i[b], one[b][1])
                   for b in range(n_batch))
        report["siou_batched_equals_per_shape"] = same
        check(same, "SIOU of the batch equals the one-shape calls, bitwise "
              "(seg_iou " + ", ".join(f"{float(v):.5f}" for v in seg) + ")")

        # the coverage draw's cdf of the first timed shape's trimmed area
        # weights, built 20 times each way: a 1-d CUDA cumsum (a look-back
        # scan), and fixed_order_cdf, which protocol_coverage takes
        c_pts, c_surf, c_w = cov_args[:3]
        sub = c_pts[::max(1, c_pts.shape[0] // tp.COV_TRIM_POINTS)]
        w = c_w * (tp.min_sqdist(c_surf, sub.contiguous())
                   <= tp.COV_TRIM_EPS ** 2)
        distinct = {}
        for how, fn in (("torch.cumsum", lambda: torch.cumsum(w, dim=0)),
                        ("fixed_order_cdf", lambda: tp.fixed_order_cdf(w))):
            seen = []
            for _ in range(20):
                c = fn()
                if not any(torch.equal(c, u) for u in seen):
                    seen.append(c)
            distinct[how] = len(seen)
        report["cdf_distinct_of_20"] = distinct
        print(f"  coverage cdf of one shape's {w.numel()} area weights, "
              f"distinct results in 20 builds: {distinct}", flush=True)
        check(distinct["fixed_order_cdf"] == 1, "the coverage cdf repeats "
              "bit for bit (fixed_order_cdf, 20 builds)")

        # stream a again from the same generator state: every per-shape
        # metric, the coverage's included, must repeat bit for bit
        after = gen.get_state()
        gen.set_state(gen_state)
        again = stream_a(iters, spline_fit)
        check(torch.equal(gen.get_state(), after), "the second run of "
              "stream a draws as many numbers as the first")
        report["slice_repeat"] = {"per_shape": again[0],
                                  "ms_per_shape": 1000.0 * again[1]
                                  / (iters * n_batch)}
        for k in ("p_cov", "sk_1", "sk_2", "seg_iou", "prim_iou",
                  "residual"):
            diff = [i for i, (u, v) in enumerate(zip(out[0][k],
                                                     again[0][k])) if u != v]
            check(not diff and len(out[0][k]) == iters * n_batch,
                  f"stream a twice: {k} equal bit for bit at all "
                  f"{iters * n_batch} shapes (differs at {diff})")
        ms_again = report["slice_repeat"]["ms_per_shape"]
        print(f"  stream a, second run: {ms_again:.2f} ms/shape; sk_2 "
              f"{np.mean(again[0]['sk_2']):.5f}, p_cov "
              f"{np.mean(again[0]['p_cov']):.5f}", flush=True)

    phase(slice_run)

    def spline_free_run():
        report_arm("slice_spline_free", "stream a, spline-free path", 2,
                   *stream_a(2, None), REFERENCE_ABLATE, "JAX spline-free")

    phase(spline_free_run)

    # ---- 4b. the library's default mean-shift (f32, K1 on 3xTF32) on one
    # batch of stream a, beside bf16 on the same 4 shapes
    def f32_batch():
        s = slice(warmup * n_batch, (warmup + 1) * n_batch)  # first timed
        runs = {}
        for bf16 in (True, False):
            for _ in range(2):   # the second run of each mode is reported
                g_b = torch.Generator(device=dev)
                g_b.manual_seed(4)
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = tp.run_batch(model, pts[s], normals[s], labels[s],
                                 prim[s], g_b, ms_bf16=bf16, device=dev)
                torch.cuda.synchronize()
                runs[bf16] = (m, 1000.0 * (time.perf_counter() - t0)
                              / n_batch, dict(kernels.LAUNCHES))
        report["f32_batch"] = {("bf16" if k else "f32"): {
            "per_shape": v[0], "ms_per_shape": v[1], "launches": v[2]}
            for k, v in runs.items()}
        keys = ("seg_iou", "prim_iou", "residual", "p_cov", "sk_2")
        print(f"[4b f32 mean-shift] {n_batch} stream-a shapes: f32 "
              f"{runs[False][1]:.2f} ms/shape, bf16 {runs[True][1]:.2f} "
              "ms/shape; " + ", ".join(
                  f"{k} {np.mean(runs[False][0][k]):.5f} (bf16 "
                  f"{np.mean(runs[True][0][k]):.5f})" for k in keys),
              flush=True)
        print(f"  launches: f32 {runs[False][2]}, bf16 {runs[True][2]}")
        check(runs[False][2]["K1"] > 0 and runs[False][2]["K1tc"] == 0,
              f"f32 batch launched the 3xTF32 K1 ({runs[False][2]['K1']}) "
              "and not the bf16 one")
        check(all(np.isfinite(np.mean(runs[False][0][k])) for k in keys),
              "f32 batch metrics finite")

    phase(f32_batch)

    # ---- 4c. the early-exit path: guard_mean_shift with tol on the first
    # timed batch's embeddings, as scripts/torch_ab_mean_shift.py runs it
    def exit_path():
        s = slice(warmup * n_batch, (warmup + 1) * n_batch)
        with torch.no_grad():
            e = model(torch.from_numpy(np.concatenate(
                [pts[s], normals[s]], -1)).to(dev))[0]
        e = e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-12)
        out = report["exit_path"] = {}
        for bf16 in (True, False):
            mode = "bf16" if bf16 else "f32"
            runs = {}
            for tol in (0.0, EXIT_TOL):
                g_x = torch.Generator(device=dev)
                g_x.manual_seed(5)
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                labs = [guarded(lambda: ms.guard_mean_shift(
                    e[i].contiguous(), 0.015, num_samples=5000,
                    iterations=50, bf16_dots=bf16, generator=g_x,
                    tol=tol)).labels.cpu().numpy() for i in range(n_batch)]
                torch.cuda.synchronize()
                runs[tol] = (labs, 1000.0 * (time.perf_counter() - t0)
                             / n_batch, dict(kernels.LAUNCHES))
            agree = [co_membership(a, b) for a, b in
                     zip(runs[EXIT_TOL][0], runs[0.0][0])]
            launches = runs[EXIT_TOL][2]
            kname = "K1tc_exit" if bf16 else "K1_exit"
            out[mode] = {"ms_per_shape": runs[EXIT_TOL][1],
                         "ms_per_shape_tol0": runs[0.0][1],
                         "co_membership": agree, "launches": launches}
            print(f"[4c exit path] guard_mean_shift {mode}, tol {EXIT_TOL:g}:"
                  f" {runs[EXIT_TOL][1]:.2f} ms a shape (tol = 0 "
                  f"{runs[0.0][1]:.2f}); co-membership with tol = 0: "
                  + ", ".join(f"{v:.6f}" for v in agree)
                  + f"; launches {launches}", flush=True)
            check(launches[kname] > 0, f"exit path {mode}: {kname} launched "
                  f"({launches[kname]})")
            check(min(agree) >= 0.99, f"exit path {mode}: co-membership with "
                  f"tol = 0 >= 0.99 (min {min(agree):.6f})")

    phase(exit_path)

    # ---- 4d. the test protocol: the port's CLIs at full width
    def test_protocol():
        import importlib.util
        import shutil
        from parsenet_tpu_torch.cli import generate_predictions as cgen
        from parsenet_tpu_torch.cli import test as ctest
        from parsenet_tpu_torch.eval import splines as tsplines
        from parsenet_tpu_torch.eval.metrics import iou_from_embeddings
        has = {m: importlib.util.find_spec(m) is not None
               for m in ("h5py", "matplotlib")}
        t_phase = time.perf_counter()
        out = report["test_protocol"] = {"modules": has, "launches": {
            k: 0 for k in kernels.LAUNCHES}}
        word = {True: "present", False: "absent"}
        print(f"[4d test protocol] h5py {word[has['h5py']]}, matplotlib "
              f"{word[has['matplotlib']]}: "
              + ("each CLI's main through h5 files" if has["h5py"] else
                 "the CLIs' split functions in memory") + f"; {smi}",
              flush=True)
        work = os.path.join(OUT_DIR, "test_protocol")
        shutil.rmtree(work, ignore_errors=True)
        ckpt = os.path.join(work, "logs", "checkpoints")
        os.makedirs(ckpt)
        for name in ("parsenet_e2e", "open_splinenet", "closed_splinenet"):
            shutil.copy(os.path.join(REPO, "params", f"{name}.npz"), ckpt)

        def config(name, **kw):
            kw = {"dataset": os.path.join(work, "data") + "/",
                  "log_dir": os.path.join(work, "logs"), "seed": 0, **kw}
            path = os.path.join(work, f"{name}.yml")
            with open(path, "w") as f:
                f.write("[train]\n" + "".join(
                    f'{k} = "{v}"\n' if isinstance(v, str) else
                    f"{k} = {v}\n" for k, v in kw.items()))
            return path, Config.from_file(path)

        def step(name, fn, n_shapes):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms = 1000.0 * (time.perf_counter() - t0) / n_shapes
            launches = dict(kernels.LAUNCHES)
            for k, v in launches.items():
                out["launches"][k] += v
            out[name] = {"ms_per_shape": ms, "launches": launches}
            return res, ms, launches

        n8 = proto.stop - proto.start
        seg_cfg_path, seg_cfg = config(
            "seg", model_path="parsenet_e2e", mode=5, knn_k=80, num_val=n8,
            num_test=n8)
        if has["h5py"]:
            import h5py
            os.makedirs(seg_cfg.dataset)
            for split in ("val", "test"):
                with h5py.File(f"{seg_cfg.dataset}{split}_data.h5", "w") as hf:
                    for key, a in (("points", proto_raw[0]),
                                   ("normals", proto_raw[1]),
                                   ("labels", labels[proto]),
                                   ("prim", prim[proto])):
                        hf.create_dataset(key, data=a)
            inputs = cgen.load_test_split(seg_cfg)
        else:
            inputs = (pts[proto], labels[proto], normals[proto], prim[proto])
        p_pts, p_lab, p_nrm, p_prim = inputs

        # 1. generate_predictions on 2 batches of 4
        def generate():
            if has["h5py"]:
                return cgen.main([seg_cfg_path])
            g = torch.Generator(device=dev)
            g.manual_seed(seg_cfg.seed)
            return cgen.predict_split(model, p_pts, p_nrm, p_lab, p_prim, g,
                                      device=dev)
        pred, gen_ms, l_gen = step("generate_predictions", generate, n8)
        # predict_segmentation itself on the same shapes, one generator of
        # the same seed, batches of 4: the CLI must add nothing
        g = torch.Generator(device=dev)
        g.manual_seed(seg_cfg.seed)
        direct = np.concatenate([tp.predict_segmentation(
            model, p_pts[b:b + 4], p_nrm[b:b + 4], p_lab[b:b + 4],
            p_prim[b:b + 4], generator=g, device=dev).labels.cpu().numpy()
            for b in range(0, n8, 4)])
        check(np.array_equal(pred["seg_id"], direct), "generate_predictions"
              "' seg_id equals predict_segmentation's on the same shapes "
              "and generator seed, bit for bit")
        check(l_gen["K1"] >= n8 and l_gen["K1tc"] == 0,
              f"generate_predictions: K1 f32 launched at least once a shape "
              f"({l_gen['K1']} for {n8}), the bf16 K1 never")
        check(l_gen["K2"] == n8 // 4, f"generate_predictions: K2 launched "
              f"once a batch ({l_gen['K2']} for {n8 // 4})")

        # 2. test on the 8 shapes with the 12 spline slots, then --optimize
        # on 2 of them (each refit kept, to see that it is finite)
        refits = []
        refine = ctest.refine_splines

        def keep_refit(*args):
            res = refine(*args)
            refits.append((res[0][args[5]], args[3][args[5]]))
            return res

        def run_test(argv, n_shapes):
            if has["h5py"]:
                return ctest.main([seg_cfg_path, *argv])
            g = torch.Generator(device=dev)
            g.manual_seed(seg_cfg.seed)
            return ctest.evaluate_split(
                p_pts[:n_shapes], p_nrm[:n_shapes], pred["seg_id"][:n_shapes],
                pred["pred_primitives"][:n_shapes],
                trained_spline_fit(seg_cfg.log_dir, seg_cfg.grid_size, dev),
                generator=g,
                if_optimize="--optimize" in argv, device=dev)
        metrics, test_ms, l_test = step(
            "test", lambda: run_test(["0", str(n8)], n8), n8)
        check(l_test["K3"] == 4 * n8, f"test: K3 launched 4 times a shape "
              f"({l_test['K3']} for {n8})")
        ctest.refine_splines = keep_refit
        try:
            opt, opt_ms, l_opt = step(
                "test_optimize", lambda: run_test(["0", "2", "--optimize"], 2),
                2)
        finally:
            ctest.refine_splines = refine
        n_refit = sum(int(np.any(a != b)) for a, b in refits)
        check(l_opt["K3"] == 7 * 2, f"test --optimize: K3 launched 7 times a "
              f"shape, 3 of them the refined coverage ({l_opt['K3']} for 2)")
        check(len(refits) == 2 and n_refit > 0 and all(
            np.isfinite(a).all() for a, _ in refits), "test --optimize: "
            f"{n_refit} segments refit, every refined surface finite")
        ref = report.get("slice", {}).get("per_shape", {})
        keys = ("seg_iou", "prim_iou", "residual", "p_cov", "sk_1", "sk_2")
        mean = {k: float(np.mean(pred[k] if k in pred else metrics[k]))
                for k in keys}
        mean_opt = {k: float(np.mean(opt[k])) for k in ctest.METRICS}
        phase4 = {k: float(np.mean(ref[k][:n8])) for k in keys if k in ref}
        out.update(metrics=mean, metrics_optimize=mean_opt, phase4=phase4,
                   segments_refit=n_refit, seg_iou=pred["seg_iou"])
        print(f"  generate_predictions {gen_ms:.2f} ms a shape; test "
              f"{test_ms:.2f} ms a shape; test --optimize {opt_ms:.2f} ms a "
              f"shape ({n_refit} segments refit on 2 shapes)", flush=True)
        print("  quality, f32 mean-shift: " + ", ".join(
            f"{k} {mean[k]:.5f}" + (f" (phase 4, bf16: {phase4[k]:.5f})"
                                    if k in phase4 else "") for k in keys))
        print("  --optimize on 2 shapes: " + ", ".join(
            f"{k} {v:.5f}" for k, v in mean_opt.items()))
        check(all(np.isfinite(v) for v in list(mean.values())
                  + list(mean_opt.values())), "test protocol metrics finite")

        # 3. the SplineNet tests, 2 batches of 36 patches each from the
        # shipped decoders; the refit on one batch of 4 patches
        for sname, closed in (("open", False), ("closed", True)):
            mod = ("test_closed_control_points" if closed
                   else "test_open_splines")
            s_path, s_cfg = config(
                mod, model_path=f"{sname}_splinenet", grid_size=GRID,
                batch_size=SPLINE_BATCH, num_train=1, num_val=1,
                dataset=os.path.join(work, f"{sname}_splines.h5"))
            rs = np.random.RandomState(30 + int(closed))
            if has["h5py"]:
                import h5py
                # 1 train, 1 val and 3 batches of test patches: the test
                # split's generator yields 3 - 1 batches
                raw = make_spline_batch(rs, 2 + 3 * SPLINE_BATCH,
                                        SPLINE_POINTS, GRID, closed)
                with h5py.File(s_cfg.dataset, "w") as hf:
                    hf.create_dataset("points", data=raw[0])
                    hf.create_dataset("controlpoints", data=raw[1])
                cli = importlib.import_module(f"parsenet_tpu_torch.cli.{mod}")
                run = lambda: cli.main([s_path])   # noqa: E731
            else:
                run = lambda: tsplines.evaluate_splinenet(   # noqa: E731
                    s_cfg, closed, test_gen=synthetic_batches(
                        rs, SPLINE_BATCH, SPLINE_POINTS, GRID, closed),
                    num_batches=2, device=dev)
            cd, cd_ms, l_cd = step(mod, run, 2 * SPLINE_BATCH)
            opt_cfg = s_cfg.replace(batch_size=4)
            cd_opt, cdo_ms, _ = step(
                f"{mod}_optimize", lambda: tsplines.evaluate_splinenet(
                    opt_cfg, closed, test_gen=synthetic_batches(
                        np.random.RandomState(40), 4, SPLINE_POINTS, GRID,
                        closed), num_batches=1, if_optimize=True,
                    device=dev), 4)
            out[mod].update(cd=cd["cd"], cd_optim=cd_opt["cd_optim"],
                            cd_refit_batch=cd_opt["cd"],
                            optimize_ms_per_patch=cdo_ms)
            print(f"  {mod}: cd {cd['cd']:.5f} on 2 x {SPLINE_BATCH} patches "
                  f"({cd_ms:.3f} ms a patch); --optimize on 4 patches: cd "
                  f"{cd_opt['cd']:.5f}, cd_optim {cd_opt['cd_optim']:.5f} "
                  f"({cdo_ms:.1f} ms a patch)", flush=True)
            check(l_cd["K3"] > 0 and np.isfinite(cd["cd"])
                  and np.isfinite(cd_opt["cd_optim"]),
                  f"{mod}: K3 launched ({l_cd['K3']}), cd and cd_optim finite")

        # 4. iou_from_embeddings on one shape's embedding
        with torch.no_grad():
            e = model(torch.from_numpy(np.concatenate(
                [p_pts[:1], p_nrm[:1]], -1)).to(dev))[0][0]
        g = torch.Generator(device=dev)
        g.manual_seed(seg_cfg.seed)
        (iou, _), _, l_iou = step("iou_from_embeddings", lambda: (
            iou_from_embeddings(e, p_lab[0], generator=g, device=dev)), 1)
        out["iou_from_embeddings"]["seg_iou"] = iou
        print(f"  iou_from_embeddings (30 iterations): seg_iou {iou:.5f} "
              f"(generate_predictions' 50: {pred['seg_iou'][0]:.5f}); "
              f"launches {l_iou}", flush=True)
        check(l_iou["K1"] > 0 and l_iou["K2"] == 1 and np.isfinite(iou),
              "iou_from_embeddings: K1 f32 and one K2 launched, seg_iou "
              "finite")
        out["seconds"] = time.perf_counter() - t_phase
        print(f"  launches in all: {out['launches']}; {out['seconds']:.1f} "
              "s", flush=True)
        shutil.rmtree(work, ignore_errors=True)

    phase(test_protocol)

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
        # (b) open and (c) closed through run_training, (d) their
        # validation; each run twice from the same seed and data
        for sname, warm, timed in (("open", 3, 20), ("closed", 1, 5)):
            closed = sname == "closed"
            runs = []
            for run in (1, 2):
                gen_s = synthetic_batches(np.random.RandomState(10 + closed),
                                          SPLINE_BATCH, SPLINE_POINTS, GRID,
                                          closed)
                batches = [next(gen_s) for _ in range(warm + timed + 2)]
                cfg = Config(model_path=f"chip_smoke_{sname}",
                             batch_size=SPLINE_BATCH, grid_size=GRID,
                             lr=1e-3, loss_weight=0.9, num_epochs=1, seed=0,
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
                ms_step = ev["forward"][warm][0].elapsed_time(
                    ev["optimizer"][-1][1]) / timed
                stage = {k: sum(a.elapsed_time(b) for a, b in ev[k][warm:])
                         / timed for k in tsp.STAGES}
                losses = [st["loss"] for st in res.steps]
                val_cd = res.epochs[-1]["val_cd"]
                for k in launches:
                    out["launches"][k] += launches[k]
                runs.append({"ms_per_step": ms_step,
                             "patches_per_s": SPLINE_BATCH * 1000.0 / ms_step,
                             "stage_ms_per_step": stage, "losses": losses,
                             "val_cd": val_cd, "launches": launches,
                             "warmup_steps": warm, "timed_steps": timed})
                print(f"[5 train] ({'b' if not closed else 'c'}) {sname} run "
                      f"{run}: {timed} timed steps, {ms_step:.3f} ms/step, "
                      f"{SPLINE_BATCH * 1000.0 / ms_step:.1f} patches/s; "
                      "stage ms/step: " + ", ".join(
                          f"{k} {v:.3f}" for k, v in stage.items()),
                      flush=True)
                print("  losses: " + ", ".join(f"{v:.9g}" for v in losses))
                print(f"  (d) validation chamfer (sqrt, two-sided, 2 "
                      f"batches): {val_cd:.9g}; launches {launches}",
                      flush=True)
                check(all(np.isfinite(v) for v in losses)
                      and np.isfinite(val_cd),
                      f"{sname} run {run} losses and validation chamfer "
                      "finite")
                if not closed:
                    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
                    check(last < first, f"open run {run} loss falls: mean "
                          f"of the last 5 {last:.5f} < first 5 {first:.5f}")
                check(launches["K3"] > 0 and launches["K4"] > 0,
                      f"{sname} run {run} launched K3 and K4 ({launches})")
            out[sname], out[f"{sname}_repeat"] = runs
            diff = [i + 1 for i, (a, b) in enumerate(
                zip(runs[0]["losses"], runs[1]["losses"])) if a != b]
            check(not diff and runs[0]["val_cd"] == runs[1]["val_cd"],
                  f"{sname} training repeats: two runs from one seed give "
                  f"equal losses at all {len(runs[0]['losses'])} steps and "
                  f"equal validation chamfer (first differing step "
                  f"{diff[0] if diff else None})")

    phase(train_run)

    # ---- 5e. the e2e trainer; 5s. the segmentation trainer
    from parsenet_tpu_torch.core.checkpoint import load_npz_params
    from parsenet_tpu_torch.core.config import load_config
    from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                                 params_from_jax)
    from parsenet_tpu_torch.train import train_e2e as te2e
    from parsenet_tpu_torch.train import train_seg as tseg
    shipped = load_npz_params(PARAMS)
    cpu = torch.device("cpu")

    class AfterWarmup(StageTimer):
        """A StageTimer that records nothing until `warm` optimizer
        stages (so `warm` train steps) have ended."""

        def __init__(self, warm):
            super().__init__(True)
            self.warm, self.seen = warm, 0

        def __call__(self, stage):
            if self.seen >= self.warm:
                return super().__call__(stage)
            if stage == "optimizer":
                self.seen += 1
            return contextlib.nullcontext()

    def parity_batch(cfg, where):
        """A parity config's shapes, mean-centred, and its draws, as
        scripts/e2e_train_reference.py makes them: (x, labels, prim,
        u_points, u_pairs), the draws broadcast to every shape."""
        p_, l_, n_, pr_ = make_shape_batch(np.random.RandomState(cfg["seed"]),
                                           cfg["shapes"], cfg["points"])
        p_ = p_ - p_.mean(1, keepdims=True)
        x_ = np.concatenate([p_, n_], -1).astype(np.float32)
        u_p, u_q = parity_draws(cfg["seed"])
        b_ = cfg["shapes"]
        return (torch.from_numpy(x_).to(where),
                torch.from_numpy(l_).to(where),
                torch.from_numpy(pr_).to(where),
                torch.from_numpy(u_p).to(where).expand(b_, *u_p.shape),
                torch.from_numpy(u_q).to(where).expand(b_, *u_q.shape))

    def embedding_model(where, k=80):
        m = PrimitivesEmbedding(emb_size=128, num_primitives=10, mode=5, k=k)
        m.load_state_dict(params_from_jax(shipped, m))
        return m.to(where)

    def hold(tag, got, ref, rtol):
        for i, (g, r) in enumerate(zip(got, ref)):
            print(f"  ({tag}) step {i + 1}: " + ", ".join(
                f"{k} {g[k]:.9g} (JAX {v:.9g})" for k, v in r.items()),
                flush=True)
            for k, v in r.items():
                tol = rtol[k][i] if isinstance(rtol, dict) else rtol[i]
                d = abs(g[k] - v)
                check(d <= tol * max(abs(v), 1e-3), f"{tag} step {i + 1} "
                      f"{k} within {tol:g} of JAX ({d:.2e})")

    def repeat_check(tag, runs):
        """Two runs from one seed: every step's metrics and the
        validation's equal bit for bit; the first differing step
        printed."""
        a_, b_ = runs
        diff = [i + 1 for i, (u, v) in enumerate(zip(a_["steps"],
                                                     b_["steps"])) if u != v]
        same = not diff and a_["val"] == b_["val"]
        report[f"{tag}_repeats"] = {"equal": same, "first_differing_step":
                                    diff[0] if diff else None}
        print(f"  {tag} twice from one seed: every loss and metric equal: "
              f"{same} (first differing step {diff[0] if diff else None})",
              flush=True)
        return same

    def train_full(tag, run, timed, shapes_per_step):
        """Two runs of `run` (a run_training call from one seed), each
        with `timed` timed steps after one warm-up: ms a step, shapes/s,
        stage ms, peak memory, launches."""
        runs = []
        for i in (1, 2):
            timer = AfterWarmup(1)
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            res = run(timer)
            launches = dict(kernels.LAUNCHES)
            timer.ms()
            ev = timer.events
            # from the first timed step's first stage to its last's end
            ms_step = next(iter(ev.values()))[0][0].elapsed_time(
                ev["optimizer"][-1][1]) / timed
            stage = {k: sum(x.elapsed_time(y) for x, y in v) / timed
                     for k, v in ev.items()}
            steps = [{k: float(v) for k, v in m.items()} for m in res.steps]
            val = {k: v for k, v in res.epochs[-1].items()
                   if k.startswith("val")}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            runs.append({"ms_per_step": ms_step,
                         "shapes_per_s": shapes_per_step * 1000.0 / ms_step,
                         "stage_ms_per_step": stage, "steps": steps,
                         "val": val, "peak_gib": peak,
                         "launches": launches})
            print(f"[{tag}] run {i}: {timed} timed steps, {ms_step:.1f} "
                  f"ms/step, {shapes_per_step * 1000.0 / ms_step:.2f} "
                  f"shapes/s, peak memory {peak:.2f} GiB; stage ms/step: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in stage.items()),
                  flush=True)
            for j, st in enumerate(steps):
                print(f"  step {j + 1}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in st.items()))
            print(f"  validation {val}; launches {launches}", flush=True)
            check(all(np.isfinite(v) for st in steps for v in st.values())
                  and all(np.isfinite(v) for v in val.values()),
                  f"{tag} run {i}: losses and metrics finite")
            check(all(st["grad_ok"] == 1.0 for st in steps),
                  f"{tag} run {i}: grad_ok 1 at every step")
        return runs

    def e2e_run():
        out = report["e2e"] = {}
        cfg = E2E_PARITY
        # (a) parity: two steps on the card from the shipped weights and
        # decoders against the JAX package; between them the card's step-1
        # gradients against the port's plain path on the CPU
        models, steps, batches = {}, {}, {}
        for where in (dev, cpu):
            models[where] = embedding_model(where, cfg["k"])
            fit = spline_fit if where == dev else build_spline_fit(
                device=cpu)
            steps[where] = te2e.make_e2e_step(
                models[where], fit, make_optimizer(
                    models[where].parameters(), "adam", cfg["lr"]),
                lamb=0.1)[0]
            x_, l_, p_, u_p, u_q = parity_batch(cfg, where)
            batches[where] = (x_[None], l_[None], p_[None],
                              [te2e.E2EDraws(u_p, u_q, None)], cfg["lr"])
        kernels.reset_launches()
        got = [steps[dev](*batches[dev])]
        parity_launches = dict(kernels.LAUNCHES)
        on_cpu = steps[cpu](*batches[cpu])
        # NMS is decided by last bits, so the card and the CPU may cluster
        # the shape otherwise; gradients are compared only where both
        # found as many clusters
        same_clusters = float(got[0]["clusters"]) == float(on_cpu["clusters"])
        grad_err = {}
        for (pname, p), q in zip(models[dev].named_parameters(),
                                 models[cpu].parameters()):
            a_, b_ = p.grad.cpu().double().ravel(), q.grad.double().ravel()
            grad_err[pname] = (float((a_ - b_).norm() / (b_.norm() + 1e-30)),
                               float(a_ @ b_ / (a_.norm() * b_.norm()
                                                + 1e-30)),
                               float(b_.norm()))
        got.append(steps[dev](*batches[dev]))
        got = [{k: float(v) for k, v in g.items()} for g in got]
        out["parity"] = {"steps": got, "grad_err": grad_err,
                         "grads_compared": same_clusters,
                         "launches_step1": parity_launches}
        hold("5e e2e parity", got, E2E_REFERENCE, E2E_RTOL)
        worst = max(grad_err, key=lambda n: grad_err[n][0])
        print("  step 1 gradients, card vs CPU plain path, largest relative "
              "L2: " + ", ".join(f"{n} {grad_err[n][0]:.2e} (cos "
                                 f"{grad_err[n][1]:.6f})" for n in sorted(
                                     grad_err, key=lambda n: -grad_err[n][0]
                                 )[:5]), flush=True)
        if not same_clusters:
            print(f"  step 1 gradients not compared: the card found "
                  f"{float(got[0]['clusters']):g} clusters, the CPU "
                  f"{float(on_cpu['clusters']):g}", flush=True)
        check(not same_clusters
              or all(c >= E2E_GRAD_COS or (r <= 1e-9 and e <= 1.0)
                     for e, c, r in grad_err.values()),
              f"e2e step-1 gradients of all {len(grad_err)} tensors at "
              f"cosine >= {E2E_GRAD_COS} with the CPU's (worst relative L2 "
              f"{worst}: {grad_err[worst][0]:.2e})")

        # (b) configs/config_parsenet_e2e.yml at full width: 8,000 of
        # 10,000 points, k 80, batch 1, accum 5, lr 1e-4, from the shipped
        # weights and decoders; synthetic shapes; 1 warm-up + 3 timed
        # steps, then eval_step on a fixed 2-shape validation sample
        conf = load_config(os.path.join(REPO, "configs",
                                         "config_parsenet_e2e.yml")).replace(
            num_epochs=1, model_path="chip_smoke_e2e",
            log_dir=os.path.join(OUT_DIR, "train_logs"))
        per_step = conf.batch_size * conf.accum

        def run(timer):
            tr = make_shape_batch(np.random.RandomState(20), 4 * per_step,
                                  10000)
            va = make_shape_batch(np.random.RandomState(21), 2, 10000)
            tr_gen = (tuple(a[i:i + per_step] for a in tr)
                      for i in range(0, 4 * per_step, per_step))
            va_gen = (tuple(a[i:i + 1] for a in va) for i in range(2))
            return te2e.run_training(
                conf, tr_gen, va_gen, steps_per_epoch=4,
                points_per_shape=conf.num_points, pretrained=shipped,
                spline_fit=spline_fit, val_shapes=2, checkpoint=False,
                device=dev, timer=timer)

        runs = train_full("5e e2e", run, 3, per_step)
        out["full"], out["full_repeat"] = runs
        for kname in ("K1", "K2", "K3", "K4"):
            check(runs[0]["launches"][kname] > 0, f"e2e run launched "
                  f"{kname} ({runs[0]['launches'][kname]})")
        repeat_check("e2e", runs)

    phase(e2e_run)

    def seg_run():
        out = report["seg"] = {}
        cfg = SEG_PARITY
        # (a) parity: two steps on the card from the shipped weights
        a_ = cfg["accum"]
        micro = (a_, cfg["shapes"] // a_)
        model_s = embedding_model(dev, cfg["k"])
        step_s = tseg.make_step_fns(model_s, make_optimizer(
            model_s.parameters(), "adam", cfg["lr"]))[0]
        batch = [t.reshape(*micro, *t.shape[1:])
                 for t in parity_batch(cfg, dev)]
        got = [{k: float(v) for k, v in step_s(*batch, cfg["lr"]).items()}
               for _ in range(2)]
        out["parity"] = got
        hold("5s seg parity", got, SEG_REFERENCE, SEG_RTOL)

        # (b) configs/config_parsenet_normals.yml at full width: 7,000 of
        # 10,000 points, batch 8, accum 3, k 80, lr 0.01, from the seeded
        # initialisation; 1 warm-up + 3 timed steps, the validation on 8
        # fixed shapes
        conf = load_config(os.path.join(REPO, "configs",
                                         "config_parsenet_normals.yml")
                           ).replace(num_epochs=1, model_path="chip_smoke_seg",
                                     log_dir=os.path.join(OUT_DIR,
                                                          "train_logs"))
        per_step = conf.batch_size * conf.accum

        def run(timer):
            tr = make_shape_batch(np.random.RandomState(30), 4 * per_step,
                                  10000)
            va = make_shape_batch(np.random.RandomState(31), conf.batch_size,
                                  10000)
            tr_gen = (tuple(a[i:i + per_step] for a in tr)
                      for i in range(0, 4 * per_step, per_step))
            return tseg.run_training(conf, tr_gen, iter([va]),
                                     steps_per_epoch=4,
                                     val_shapes=conf.batch_size,
                                     checkpoint=False, device=dev,
                                     timer=timer)

        runs = train_full("5s seg", run, 3, per_step)
        out["full"], out["full_repeat"] = runs
        repeat_check("seg", runs)

    phase(seg_run)

    # ---- 7. the port's benches in process: cli.bench at full scale (the
    # full path and both bf16 network knobs), then
    # cli.bench_train with shortened step counts; every run's launches
    # counted from zero
    from parsenet_tpu_torch.cli import bench as cbench
    from parsenet_tpu_torch.cli import bench_train as cbt
    bench_l = {k: 0 for k in kernels.LAUNCHES}

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            bench_l[k] += v
        return out, launches

    def bench_run():
        out = report["bench"] = {}
        t_phase = time.perf_counter()
        with contextlib.chdir(REPO):
            for tag, env in BENCH_RUNS.items():
                rec, launches = counted(lambda: cbench.run(
                    cbench.settings(env), dev))
                d = rec["detail"]
                out[tag] = {"record": rec, "launches": launches}
                print(f"[7 bench] {tag}: {d['per_shape_ms']:.2f} ms/shape, "
                      f"{rec['value']:.1f} shapes/hour; residual "
                      f"{d['residual']:.5f} seg_iou {d['seg_iou']:.5f} p_cov "
                      f"{d['p_cov']:.5f} sk_2 {d['sk_2']:.5f}; floors applied "
                      f"{d['floors_applied']}, quality_ok {d['quality_ok']}; "
                      f"launches K1tc {launches['K1tc']} K1 {launches['K1']} "
                      f"K2 {launches['K2']} K3 {launches['K3']}", flush=True)
                check(all(np.isfinite(d[k]) for k in BENCH_QUALITY)
                      and rec["value"] > 0, f"bench {tag}: finite metrics")
                check(d["floors_applied"] and d["quality_ok"]
                      and d["trained_params"],
                      f"bench {tag}: floors applied and met")
                for k in BENCH_QUALITY:
                    got, want = d[k], REFERENCE_FULL[k]
                    tol = 0.01 if k in ("seg_iou", "sk_2") else 0.1 * want
                    check(abs(got - want) <= tol,
                          f"bench {tag}: {k} {got:.5f} against the JAX "
                          f"full path's {want} (0.01 absolute, 10% "
                          "relative)")
                for kname in ("K1tc", "K2", "K3"):
                    check(launches[kname] > 0,
                          f"bench {tag}: {kname} launched {launches[kname]}")
                check(launches["K1"] == 0, f"bench {tag}: no f32 K1")
            full = out["full"]["record"]["detail"]["per_shape_ms"]
            print(f"  full path {full:.2f} ms/shape beside phase 4's "
                  f"{report.get('slice', {}).get('ms_per_shape', 0.0):.2f} "
                  "in this call", flush=True)
            # cli.bench_train: shortened step counts (the script's own
            # defaults are 5 seg and 3 e2e timed steps)
            for tag, fn, env, want in (
                    ("seg", cbt.bench_seg, {}, ()),
                    ("seg_bf16", cbt.bench_seg, {"BT_BF16": "1"}, ()),
                    ("seg_remat", cbt.bench_seg, {"BT_REMAT": "1"}, ()),
                    ("e2e", cbt.bench_e2e, {}, ("K1", "K2", "K3", "K4")),
                    ("e2e_fast", cbt.bench_e2e, {"BT_FAST": "1"},
                     ("K1", "K2", "K3", "K4"))):
                steps = 2 if tag.startswith("seg") else 3
                rec, launches = counted(lambda: fn(env, steps=steps,
                                                   device=dev))
                d = rec["detail"]
                out[tag] = {"record": rec, "launches": launches}
                print(f"[7 bench_train] {tag}: {rec['value']:.3f} shapes/s, "
                      f"{d['step_ms']:.1f} ms/step, peak "
                      f"{d['peak_mem_gib'] or 0.0:.2f} GiB, launches {launches}",
                      flush=True)
                check(rec["value"] > 0 and d.get("grad_ok") == 1.0,
                      f"bench_train {tag}: grad_ok 1")
                for kname in want:
                    check(launches[kname] > 0,
                          f"bench_train {tag}: {kname} launched")
        out["launches"] = dict(bench_l)
        out["seconds"] = time.perf_counter() - t_phase
        print(f"[7 bench] {out['seconds']:.1f} s, launches {bench_l}",
              flush=True)

    phase(bench_run)

    # ---- 9. (run before 6) data parallelism, sharded inference, the ring
    # ops and the library functions of the last slice, in one NCCL rank
    def dp_run():
        x_, l_, p_, u_p, u_q = parity_batch(E2E_PARITY, dev)
        e2e_batch = (x_[None], l_[None], p_[None],
                     [te2e.E2EDraws(u_p, u_q, None)], E2E_PARITY["lr"])
        spline_in = {"basis": (nu, nv)}
        for sname in ("open", "closed"):
            spline_in[sname] = (
                lambda sname=sname: load_splinenet(
                    os.path.join(REPO, "params", f"{sname}_splinenet.npz"),
                    int(sname == "closed"), GRID, device=dev),
                spline_batches[sname])
        timed = [slice(b * n_batch, (b + 1) * n_batch)
                 for b in range(warmup, warmup + iters)]
        return dp_phase(dev, report, model, spline_fit,
                        (pts, normals, labels, prim, timed), embn,
                        (lambda: embedding_model(dev, E2E_PARITY["k"]),
                         spline_fit, e2e_batch), spline_in)

    phase(dp_run)

    # ---- 10. (run before 6) the route from a fine-tune to shipped weights
    def ft_run():
        shipped_a = report.get("bench", {}).get("full", {}).get("record")
        return finetune_phase(dev, report, model, spline_fit,
                              (pts, normals, labels, prim), shipped_a)

    phase(ft_run)

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
                embn, bw, it, bf16_dots=bf16), 10 if bf16 else 5)
            p_ms = cuda_ms(lambda: kernels.mean_shift_iterations_plain(
                embn, bw, it, bf16_dots=bf16), 3)
            xs = embn.to(torch.bfloat16) if bf16 else embn
            l_ms = cuda_ms(lambda: sdpa_mean_shift(xs, bw_f, it), 3)
            tag = "bf16" if bf16 else "f32"
            if bf16:
                bound = 1000.0 * max(k1_flops / PEAK_BF16,
                                     k1_bytes / HBM_BYTES_S)
                extra = f", exp floor on the MUFU units {mufu_ms:.3f} ms"
            else:
                # the f32 function on the tensor cores in 3xTF32 (three
                # products for each one), or on the CUDA cores' f32 FMA:
                # the smaller is the bound
                tf32_ms = 1000.0 * 3 * k1_flops / PEAK_TF32
                fma_ms = 1000.0 * k1_flops / PEAK_FP32
                bound = max(min(tf32_ms, fma_ms),
                            1000.0 * k1_bytes / HBM_BYTES_S)
                extra = (f" (3xTF32 on the tensor cores {tf32_ms:.3f} ms, "
                         f"f32 FMA on the CUDA cores {fma_ms:.3f} ms), exp "
                         f"floor on the MUFU units {mufu_ms:.3f} ms")
            print(f"[6 times] K1 {tag} (tensor cores, "
                  f"{'bf16' if bf16 else '3xTF32'}) 10000x128x50: kernel "
                  f"{k_ms:.3f} ms ({k1_flops / k_ms / 1e9:.1f} TFLOP/s of the "
                  f"f32 function, {100.0 * bound / k_ms:.1f}% of the bound), "
                  f"plain {p_ms:.3f} ms, SDPA yardstick {l_ms:.3f} ms, bound "
                  f"{bound:.3f} ms (operations){extra}", flush=True)
            report[f"K1_{tag}_ms"] = (k_ms, p_ms, bound, l_ms)
        # the 3xTF32 K1's two grids at 10,000 and 4,999 stream-a rows
        inv = kernels._inv2b2(bw, dev)
        grids = {}
        for rows in (n, 4999):
            x_r = embn[:rows].contiguous()
            for g in (kernels.ms_plan(rows, sms, kernels.MS_TF32_TILE)[0],
                      -(-rows // kernels.MS_BLOCK_ROWS)):
                grids[f"{rows} rows, grid {g}"] = cuda_ms(
                    lambda: kernels._ms_iterations_tf32(x_r, x_r, inv, it, g),
                    3)
        report["K1_f32_grid_ms"] = grids
        print("  K1 f32 through _ms_iterations_tf32: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in grids.items()), flush=True)
        # the 3xTF32 kernel's products alone, on every SM: each score
        # operand layout and the update, a key tile's worth at a time
        # against operands held in shared memory (kernels.MS_TF32_PROBE)
        probe = {}
        for mode, (nbytes, fma) in kernels.MS_TF32_PROBE.items():
            kernels.ms_tf32_operand_probe(dev, mode, 256)
            r = kernels.ms_tf32_operand_probe(dev, mode, PROBE_TILES)
            cyc = r["cycles_per_tile"]
            # two consumer warpgroups a block, one block an SM
            probe[mode] = {"cycles_per_tile": cyc, "ms": r["ms"],
                           "bytes_per_fma": nbytes / fma,
                           "smem_bytes_per_clock": 2 * nbytes / cyc,
                           "tensor_share": 2 * fma / cyc / TF32_FMA_CLOCK}
            print(f"  K1 f32 operand probe {mode}: {cyc:.1f} cycles a tile "
                  f"({r['ms']:.3f} ms for {PROBE_TILES} tiles), "
                  f"{nbytes / fma:.4f} shared-memory bytes an FMA, "
                  f"{2 * nbytes / cyc:.1f} bytes a clock an SM, "
                  f"{100.0 * 2 * fma / cyc / TF32_FMA_CLOCK:.1f}% of the "
                  "TF32 tensor rate", flush=True)
        report["K1_f32_operand_probe"] = probe
        # the fixed-count kernel's clocks a key tile beside the probe's:
        # its units (a 128-row block against a 16-row tile) an SM over the
        # 50 iterations, at the clock the probe ran at
        k_ms = report["K1_f32_ms"][0]
        upd = probe["update"]
        ghz = upd["cycles_per_tile"] * PROBE_TILES / upd["ms"] / 1e6
        units = (it * -(-n // kernels.MS_BLOCK_ROWS)
                 * -(-n // kernels.MS_TF32_TILE) / sms)
        k_cyc = k_ms * 1e6 * ghz / units
        shares = {m: probe[f"score_{m}+update"]["cycles_per_tile"] / k_cyc
                  for m in ("rs", "rs_f16")}
        report["K1_f32_clocks_per_tile"] = {"clocks": k_cyc, "ghz": ghz,
                                            "probe_share": shares}
        print(f"  K1 f32 fixed-count 10000x128x50: {k_ms:.3f} ms, "
              f"{k_cyc:.0f} clocks a tile at {ghz:.3f} GHz; the probe's "
              f"score_rs+update is {100.0 * shares['rs']:.1f}% of it, "
              f"score_rs_f16+update (its own layout) "
              f"{100.0 * shares['rs_f16']:.1f}%", flush=True)
        # the tensor-core launch alone, without the wrapper's tiling and
        # allocations (the counters zeroed as the wrapper does)
        grid, slots = kernels.ms_plan(n, sms)
        blocks = -(-n // kernels.MS_BLOCK_ROWS)
        xt = kernels.ms_tiles_bf16(embn)
        out = torch.empty((n, kernels.MS_WIDTH), device=dev)
        ws = torch.empty(2 * blocks * slots * kernels.MS_PART_FLOATS,
                         device=dev)
        counters = torch.zeros(blocks, dtype=torch.int32, device=dev)
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
        # launches: the bf16 K1 on the slice, the f32 K1 on phase 4b's f32
        # batch (the slice runs bf16)
        f32_l = report.get("f32_batch", {}).get("f32", {}).get(
            "launches", {"K1": 0})
        # and the f32 K1's escalation attempts in the e2e phase's first
        # full-width run, at 8,000 x 128 x 5 iterations
        e2e_l = report.get("e2e", {}).get("full", {}).get(
            "launches", {k: 0 for k in kernels.LAUNCHES})
        # and every launch of phase 4d's test protocol (K1 f32, K2, K3)
        proto_l = report.get("test_protocol", {}).get(
            "launches", {k: 0 for k in kernels.LAUNCHES})
        x8 = embn[:8000].contiguous()
        e_flops = 5 * 4 * 8000 * 8000 * d
        e2e_k1 = {"ms": cuda_ms(lambda: kernels.mean_shift_iterations(
            x8, bw, 5), 10), "plain_ms": cuda_ms(
            lambda: kernels.mean_shift_iterations_plain(x8, bw, 5), 3),
            "bound_ms": 1000.0 * max(min(3 * e_flops / PEAK_TF32,
                                         e_flops / PEAK_FP32),
                                     2 * 8000 * d * 4 / HBM_BYTES_S),
            "library_ms": cuda_ms(lambda: sdpa_mean_shift(x8, bw_f, 5), 3),
            "max_abs_err": report.get("K1_f32_e2e_max_abs_err")}
        print(f"[6 times] K1 f32 at the e2e attempts' 8000x128x5: kernel "
              f"{e2e_k1['ms']:.3f} ms, plain {e2e_k1['plain_ms']:.3f} ms, "
              f"SDPA yardstick {e2e_k1['library_ms']:.3f} ms, bound "
              f"{e2e_k1['bound_ms']:.3f} ms (operations)", flush=True)
        for tag, kname, src, n_l in (
                ("f32", "K1", "ms_iterations_tf32",
                 f32_l["K1"] + e2e_l["K1"] + proto_l["K1"] + bench_l["K1"]),
                ("bf16", "K1tc", "ms_iterations_tc",
                 launches["K1tc"] + bench_l["K1tc"])):
            k_ms, p_ms, bound, l_ms = report[f"K1_{tag}_ms"]
            entries.append({
                "name": src, "route": "cuda",
                "source": f"parsenet_tpu_torch/csrc/{src}.cu",
                "replaces": "parsenet_tpu/ops/pallas_kernels.py:212",
                "launches": n_l,
                "max_abs_err": report.get(f"K1_{tag}_max_abs_err"),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": "operations", "library_ms": l_ms, "id": kname,
                "launches_bench": bench_l[kname],
                **({"launches_e2e": e2e_l["K1"], "e2e": e2e_k1,
                    "launches_protocol": proto_l["K1"]}
                   if tag == "f32" else {})})

        # K1 exit at 10,000 x 128 x 50, tol 1e-6, on the 8 stream-a
        # embeddings beside tol = 0; its bound is the fixed-count bound
        # scaled by the share of the 50 iterations its row blocks run
        exit_l = report.get("exit_path", {})
        for tag, kname, src in (("bf16", "K1tc_exit", "ms_iterations_tc"),
                                ("f32", "K1_exit", "ms_iterations_tf32")):
            bf16 = tag == "bf16"
            k_ms, k0_ms, shares, k_shares, k_live = [], [], [], [], []
            for e, b in emb8:
                k_ms.append(cuda_ms(lambda: kernels.mean_shift_iterations(
                    e, b, it, bf16_dots=bf16, tol=EXIT_TOL), 3))
                k0_ms.append(cuda_ms(lambda: kernels.mean_shift_iterations(
                    e, b, it, bf16_dots=bf16), 3))
                shares.append(float(kernels.mean_shift_exit_counts(
                    e, b, it, bf16_dots=bf16, tol=EXIT_TOL).float().mean())
                    / it)
                k_it = torch.zeros((-(-e.shape[0] // kernels.MS_BLOCK_ROWS),),
                                   dtype=torch.int32, device=dev)
                k1_launch(kernels, e, b, bf16, it, EXIT_TOL, k_it)
                k_shares.append(float(k_it.float().mean()) / it)
                k_live.append(live_per_iteration(k_it, it))
            e0, b0 = emb8[0]
            p_ms = cuda_ms(lambda: kernels.mean_shift_iterations_plain(
                e0, b0, it, bf16_dots=bf16, tol=EXIT_TOL,
                exit_rows=kernels.MS_BLOCK_ROWS), 1)
            share = float(np.mean(shares))
            bound = report[f"K1_{tag}_ms"][2] * share
            # the clustered rows of phase 3, where most row blocks leave
            # early: the exit beside tol = 0, and each one's bound (the
            # fixed-count bound at that N, scaled by the share it runs)
            clus = {}
            for ctag, x, b in exit_sets:
                if x.shape[0] < 4999:
                    continue
                c_share = float(kernels.mean_shift_exit_counts(
                    x, b, it, bf16_dots=bf16, tol=EXIT_TOL).float().mean()
                    ) / it
                c_bound = report[f"K1_{tag}_ms"][2] * c_share * (
                    x.shape[0] / embn.shape[0]) ** 2
                # the kernel's own count, beside the plain helper's
                k_it = torch.zeros((-(-x.shape[0] // kernels.MS_BLOCK_ROWS),),
                                   dtype=torch.int32, device=dev)
                k1_launch(kernels, x, b, bf16, it, EXIT_TOL, k_it)
                k_share = float(k_it.float().mean()) / it
                clus[ctag] = {
                    "ms": cuda_ms(lambda: kernels.mean_shift_iterations(
                        x, b, it, bf16_dots=bf16, tol=EXIT_TOL), 3),
                    "tol0_ms": cuda_ms(lambda: kernels.mean_shift_iterations(
                        x, b, it, bf16_dots=bf16), 3),
                    "share": c_share, "kernel_share": k_share,
                    "kernel_max_iterations": int(k_it.max()),
                    "bound_ms": c_bound,
                    "live_per_iteration": live_per_iteration(k_it, it)}
                print(f"[6 times] K1 exit {tag} {ctag} x 50, tol "
                      f"{EXIT_TOL:g}: kernel {clus[ctag]['ms']:.3f} ms, tol "
                      f"= 0 {clus[ctag]['tol0_ms']:.3f} ms (ratio "
                      f"{clus[ctag]['ms'] / clus[ctag]['tol0_ms']:.3f}); "
                      f"iterations run {100.0 * c_share:.1f}% of 50 (the "
                      f"kernel's own count {100.0 * k_share:.1f}%, its "
                      f"slowest row block {int(k_it.max())}); bound "
                      f"{c_bound:.3f} ms; live row blocks per iteration "
                      f"{runs(clus[ctag]['live_per_iteration'])}",
                      flush=True)
            # the exit's cost with nothing leaving (tol 1e-30) beside tol =
            # 0, on the first embedding: what an iteration of the exit's
            # machinery costs
            e0, b0 = emb8[0]
            none_ms = cuda_ms(lambda: kernels.mean_shift_iterations(
                e0, b0, it, bf16_dots=bf16, tol=1e-30), 3)
            print(f"  K1 exit {tag}, nothing leaving (tol 1e-30), embedding "
                  f"0: {none_ms:.3f} ms beside tol = 0's {k0_ms[0]:.3f} "
                  f"({1000.0 * (none_ms - k0_ms[0]) / it:.2f} us an "
                  "iteration)", flush=True)
            report[f"{kname}_ms"] = {"ms": k_ms, "tol0_ms": k0_ms,
                                     "none_leaving_ms": none_ms,
                                     "share": shares,
                                     "kernel_share": k_shares,
                                     "live_per_iteration": k_live,
                                     "plain_ms": p_ms, "clustered": clus}
            for i, live in enumerate(k_live):
                print(f"  K1 exit {tag} stream-a embedding {i}: live row "
                      f"blocks per iteration {runs(live)}")
            print(f"[6 times] K1 exit {tag} 10000x128x50, tol {EXIT_TOL:g}, "
                  f"8 stream-a embeddings: kernel {np.mean(k_ms):.3f} ms ("
                  + ", ".join(f"{v:.3f}" for v in k_ms) + "), tol = 0 "
                  f"{np.mean(k0_ms):.3f} ms (" + ", ".join(
                      f"{v:.3f}" for v in k0_ms) + f"; ratio of the means "
                  f"{np.mean(k_ms) / np.mean(k0_ms):.3f}); iterations run "
                  f"{100.0 * share:.1f}% of 50 (" + ", ".join(
                      f"{100.0 * v:.1f}" for v in shares) + "; the kernel's "
                  "own counts " + ", ".join(
                      f"{100.0 * v:.1f}" for v in k_shares) + f"); plain "
                  f"{p_ms:.3f} ms (embedding 0); bound {bound:.3f} ms "
                  "(the fixed-count bound x that share; library: none, the "
                  "trip count depends on the data)", flush=True)
            entries.append({
                "name": f"{src}_exit", "id": kname.replace("_", " "),
                "route": "cuda",
                "source": f"parsenet_tpu_torch/csrc/{src}.cu",
                "replaces": "parsenet_tpu/ops/pallas_kernels.py:213",
                "launches": exit_l.get(tag, {}).get("launches", {}).get(
                    kname, 0),
                "max_abs_err": report.get(f"{kname}_max_abs_err"),
                "ms": float(np.mean(k_ms)), "plain_ms": p_ms,
                "bound_ms": bound, "bound_by": "operations",
                "library_ms": None, "tol0_ms": float(np.mean(k0_ms)),
                "iteration_share": share, "clustered": clus})

        # K2 on a main-path SIOU matrix (shape 0's f32 clustering vs GT),
        # both entries; and on the 4 matrices of stream a's first timed
        # batch in one call, as the slice launches it
        lab0 = ms.nms(kernels.mean_shift_iterations(embn, bw, it), embn,
                      bw)[1]
        gt0 = torch.from_numpy(labels[0].astype(np.int64)).to(dev)
        cost0 = (1.0 - relaxed_iou(to_one_hot(lab0), to_one_hot(gt0)))
        cost0 = cost0.contiguous()
        ben0 = hg.lap_benefit(cost0)
        cost4 = siou_batch.get("costs")
        if cost4 is None:   # phase 4 failed: shape 0's matrix four times
            cost4 = cost0.expand(n_batch, -1, -1).contiguous()
        ben4 = hg.lap_benefit(cost4)
        n_k2 = cost0.shape[-1]
        n_pad = max(8, -(-n_k2 // 8) * 8)
        rounds = rounds_to_assign(kernels, hg, ben0)
        rounds4 = max(rounds_to_assign(kernels, hg, ben4[b])
                      for b in range(ben4.shape[0]))
        # each round's bidders: the persons still unassigned after the
        # rounds before it (the plain version; padding persons aside)
        bidders = [int((kernels.auction_assign_plain(
            ben0, hg._EPS0, hg._ESC_EVERY, hg._ESC, r) < 0).sum())
            for r in range(rounds)]
        report["K2_bidders_per_round"] = bidders
        print(f"[6 times] K2 shape 0: bidders of rounds 1-{rounds}: "
              + ", ".join(map(str, bidders)), flush=True)
        probe = kernels.auction_latency_probe(dev, 32 * (n_pad // 2))
        ghz = probe["clock_ghz"]
        # the least a round takes: one block barrier (at the kernel's block
        # of n_pad / 2 warps) and one 5-step shuffle reduction of a row
        round_floor_ms = (probe["barrier_cycles"]
                          + 5 * probe["shuffle_step_cycles"]) / ghz * 1e-6
        print(f"[6 times] K2 latency probe ({32 * (n_pad // 2)} threads, "
              f"{ghz:.3f} GHz): barrier {probe['barrier_cycles']:.1f} "
              f"cycles, shuffle step {probe['shuffle_step_cycles']:.1f}, "
              f"redux.sync {probe['redux_cycles']:.1f}; a round's floor "
              f"{round_floor_ms * 1e3:.4f} us", flush=True)
        report["K2_probe"] = probe
        args = (hg._EPS0, hg._ESC_EVERY, hg._ESC)
        for ename, kname, fn, plain, x0, x4 in (
                ("lap_assign", "K2", kernels.lap_assign,
                 kernels.lap_assign_plain, cost0, cost4),
                ("auction_assign", "K2_benefit", kernels.auction_assign,
                 kernels.auction_assign_plain, ben0, ben4)):
            err = max(float((fn(x, *args, 3000) - plain(x, *args, 3000))
                            .abs().max()) for x in (x0, x4))
            k_ms = cuda_ms(lambda: fn(x0, *args, 3000), 20)
            k_dev = graph_ms(lambda: fn(x0, *args, 3000), 20)
            k4_ms = cuda_ms(lambda: fn(x4, *args, 3000), 20)
            k4_dev = graph_ms(lambda: fn(x4, *args, 3000), 20)
            one_dev = graph_ms(lambda: fn(x0, *args, 1), 20)
            round_ms = (k_dev - one_dev) / max(rounds - 1, 1)
            p_ms = cuda_ms(lambda: plain(x0, *args, 3000), 5)
            lat_bound = rounds * round_floor_ms
            # the contract's bound: each input byte read once, each output
            # written once; a round's operations on the padded matrix
            k2_ops = rounds * 4 * n_pad * n_pad
            k2_bytes = n_k2 * n_k2 * 4 + n_k2 * 4
            bound = 1000.0 * max(k2_ops / PEAK_FP32, k2_bytes / HBM_BYTES_S)
            by = ("operations" if k2_ops / PEAK_FP32 > k2_bytes / HBM_BYTES_S
                  else "bytes")
            print(f"[6 times] K2 {ename} {n_k2}x{n_k2} ({rounds} rounds to "
                  f"assign all): device {k_dev:.4f} ms, eager {k_ms:.4f} ms; "
                  f"{x4.shape[0]} matrices in one call ({rounds4} rounds): "
                  f"device {k4_dev:.4f} ms, eager {k4_ms:.4f} ms; one round "
                  f"{one_dev:.4f} ms device, so {round_ms * 1e3:.4f} us a "
                  f"round against a floor of {round_floor_ms * 1e3:.4f}; "
                  f"latency bound {lat_bound:.4f} ms ({rounds} x the "
                  f"floor); plain {p_ms:.3f} ms; {by} bound {bound:.7f} ms "
                  "(not binding)", flush=True)
            entries.append({
                "name": ename, "route": "cuda",
                "source": "parsenet_tpu_torch/csrc/auction_assign.cu",
                "replaces": "parsenet_tpu/ops/pallas_kernels.py:345",
                "launches": launches[kname] + e2e_l.get(kname, 0)
                + proto_l.get(kname, 0) + bench_l.get(kname, 0),
                "launches_e2e": e2e_l.get(kname, 0),
                "launches_bench": bench_l.get(kname, 0),
                "launches_protocol": proto_l.get(kname, 0), "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None, "device_ms": k_dev,
                "batch_ms": k4_ms, "batch_device_ms": k4_dev,
                "batch": int(x4.shape[0]), "batch_rounds": rounds4,
                "rounds": rounds, "one_round_device_ms": one_dev,
                "round_ms": round_ms, "round_floor_ms": round_floor_ms,
                "latency_bound_ms": lat_bound, "id": kname})

        # K3: one shape's four calls (trim, points->samples,
        # samples->points, and the 12 spline slots' residual in one batch)
        p0 = torch.from_numpy(pts[0]).to(dev)
        rec = tp.reconstruct_shape(p0, torch.from_numpy(normals[0]).to(dev),
                                   lab0, prim0, generator=gen,
                                   spline_fit=spline_fit, device=dev)
        flat = rec.surface_points.reshape(-1, 3).contiguous()
        samp = flat[torch.randint(0, flat.shape[0], (10000,), device=dev,
                                  generator=gen)].contiguous()
        n_slots = tp.EVAL_SPLINE_SLOTS
        calls = [(flat, p0[::4].contiguous()), (p0, samp), (samp, p0),
                 (p0.expand(n_slots, -1, -1).contiguous(),
                  rec.surface_points[:n_slots].contiguous())]
        tot = {k: 0.0 for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                "library_device_ms", "bound")}
        per_call, err = [], 0.0
        for qq, xx in calls:
            bq = qq.shape[0] if qq.dim() == 3 else 1
            nq, mx = qq.shape[-2], xx.shape[-2]
            b = 1000.0 * max(8 * bq * nq * mx / PEAK_FP32,
                             bq * ((nq + mx) * 3 * 4 + nq * 8) / HBM_BYTES_S)
            t = time_k3(kernels, qq, xx, 10)
            t["plain_ms"] = cuda_ms(
                lambda: kernels.min_sqdist_with_idx_plain(qq, xx), 3)
            t["bound"] = b
            err = max(err, float((kernels.min_sqdist_with_idx(qq, xx)[0]
                                  - kernels.min_sqdist_with_idx_plain(
                                      qq, xx)[0]).abs().max()))
            print(f"[6 times] K3 {bq}x{nq}x{mx} (plan "
                  f"{kernels.min_sqdist_plan(bq, nq, mx, sms)}): "
                  + k3_line(t) + f", plain {t['plain_ms']:.4f} ms, bound "
                  f"{b:.4f} ms (operations)", flush=True)
            per_call.append({"shape": [bq, nq, mx], **t})
            for k in tot:
                tot[k] += t[k]
        print(f"  K3 summed over the shape's four calls: {tot['ms']:.4f} ms "
              f"eager, {tot['device_ms']:.4f} ms device; cdist "
              f"{tot['library_ms']:.4f} / {tot['library_device_ms']:.4f}; "
              f"bound {tot['bound']:.4f} ms", flush=True)
        # K3 at the e2e loss's slot chamfer, 4 x (8,000 vs 900)
        e2e_k3 = {}
        if e2e_shapes:
            qe, xe = e2e_shapes["q"], e2e_shapes["x"]
            e2e_k3 = time_k3(kernels, qe, xe, 20)
            e2e_k3["plain_ms"] = cuda_ms(
                lambda: kernels.min_sqdist_with_idx_plain(qe, xe), 3)
            e2e_k3["bound_ms"] = 1000.0 * max(
                8 * 4 * 8000 * 900 / PEAK_FP32,
                4 * ((8000 + 900) * 12 + 8000 * 8) / HBM_BYTES_S)
            print("[6 times] K3 at the e2e slot chamfer 4x(8000 vs 900): "
                  + k3_line(e2e_k3) + f", plain {e2e_k3['plain_ms']:.4f} "
                  f"ms, bound {e2e_k3['bound_ms']:.5f} ms (operations)",
                  flush=True)
        # K3 batched at the training shape: one launch per train step
        train_l = report.get("train", {}).get(
            "launches", {k: 0 for k in kernels.LAUNCHES})
        bq, nq, mx = tq.shape[0], tq.shape[1], tx.shape[1]
        t_bound = 1000.0 * max(8 * bq * nq * mx / PEAK_FP32,
                               bq * ((nq + mx) * 12 + nq * 8) / HBM_BYTES_S)
        tt = time_k3(kernels, tq, tx, 50)
        t_plain = cuda_ms(lambda: kernels.min_sqdist_with_idx_plain(tq, tx),
                          10)
        print(f"[6 times] K3 batched {bq}x({nq} vs {mx}) (plan "
              f"{kernels.min_sqdist_plan(bq, nq, mx, sms)}): " + k3_line(tt)
              + f", plain {t_plain:.4f} ms, bound {t_bound:.5f} ms "
              "(operations)", flush=True)
        entries.append({
            "name": "min_sqdist_idx", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/min_sqdist.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:418",
            "launches": launches["K3"] + train_l["K3"] + e2e_l["K3"]
            + proto_l["K3"] + bench_l["K3"],
            "launches_bench": bench_l["K3"],
            "max_abs_err": max(err, report.get("K3_train_max_abs_err", 0.0)),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound"], "bound_by": "operations",
            "library_ms": tot["library_ms"],
            "device_ms": tot["device_ms"],
            "library_device_ms": tot["library_device_ms"],
            "calls": per_call,
            "launches_inference": launches["K3"],
            "launches_train": train_l["K3"],
            "launches_e2e": e2e_l["K3"], "e2e": e2e_k3,
            "launches_protocol": proto_l["K3"],
            "train_ms": tt["ms"], "train_device_ms": tt["device_ms"],
            "train_plain_ms": t_plain, "train_bound_ms": t_bound,
            "train_library_ms": tt["library_ms"],
            "train_library_device_ms": tt["library_device_ms"], "id": "K3"})

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
        k4 = time_k4(kernels, tq, tx, idx, g_k4, 50)
        k4_plain = cuda_ms(lambda: kernels.min_sqdist_bwd_plain(
            tq, tx, idx, g_k4), 20)
        print(f"[6 times] K4 {bq}x({nq} vs {mx}): kernel {k4['ms']:.4f} ms "
              f"eager as MinSqdist calls it ({k4['checked_ms']:.4f} through "
              f"min_sqdist_bwd's checks), {k4['device_ms']:.4f} ms device; "
              f"plain {k4_plain:.4f} "
              f"ms; index_add_ {k4['library_ms']:.4f} ms eager, "
              f"{k4['library_device_ms']:.4f} ms device; bound "
              f"{k4_bound:.5f} ms (bytes: {k4_bytes} bytes, {n_rows} "
              "distinct argmin rows)", flush=True)
        # K4 at the e2e slot chamfer, on K3's argmins there, with the
        # gradient the e2e loss gives it: the mean over each slot's GT
        # segment, 0 on the other points, which K4 leaves out of its chains
        e2e_k4 = {}
        if e2e_shapes:
            qe, xe = e2e_shapes["q"], e2e_shapes["x"]
            on_seg = e2e_shapes["on_seg"]
            ie = kernels.min_sqdist_with_idx(qe, xe)[1]
            ge = on_seg / (on_seg.sum(1, keepdim=True) + 1e-7)
            e2e_k4 = time_k4(kernels, qe, xe, ie, ge, 10)
            e2e_k4["plain_ms"] = cuda_ms(lambda: kernels.min_sqdist_bwd_plain(
                qe, xe, ie, ge), 1)
            rows_e = (ie.long() + 900 * torch.arange(4, device=dev)[:, None]
                      )[ge != 0]
            e2e_k4["longest_chain"] = int(torch.bincount(rows_e).max())
            e2e_k4["longest_chain_all"] = int(torch.bincount(
                (ie.long() + 900 * torch.arange(4, device=dev)[:, None])
                .reshape(-1)).max())
            # every query's q, g, idx read and dq written; the argmin rows
            # of the queries with a gradient read; dx written
            e_rows = int(torch.unique(rows_e).numel())
            e2e_k4["bound_ms"] = 1000.0 * (4 * 8000 * 32 + e_rows * 12
                                           + 4 * 900 * 12) / HBM_BYTES_S
            print(f"[6 times] K4 at the e2e slot chamfer 4x(8000 vs 900), "
                  f"the loss's gradient: {e2e_k4['ms']:.4f} ms eager, "
                  f"{e2e_k4['device_ms']:.4f} ms device, plain "
                  f"{e2e_k4['plain_ms']:.4f} ms, bound "
                  f"{e2e_k4['bound_ms']:.5f} ms (bytes); longest chain "
                  f"{e2e_k4['longest_chain']} queries with a gradient "
                  f"({e2e_k4['longest_chain_all']} of all queries)",
                  flush=True)
        entries.append({
            "name": "min_sqdist_bwd", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/min_sqdist_bwd.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:463",
            "launches": train_l["K4"] + e2e_l["K4"] + bench_l["K4"],
            "launches_e2e": e2e_l["K4"], "e2e": e2e_k4,
            "launches_bench": bench_l["K4"],
            "max_abs_err": report.get("K4_max_abs_err"),
            "ms": k4["ms"], "plain_ms": k4_plain, "bound_ms": k4_bound,
            "bound_by": "bytes", "library_ms": k4["library_ms"],
            "device_ms": k4["device_ms"], "checked_ms": k4["checked_ms"],
            "library_device_ms": k4["library_device_ms"], "id": "K4"})

        # K5: one step at 10,000 x 128 (no program path runs it); its
        # yardstick is one f32 SDPA step of the same queries and keys; its
        # bound the 3xTF32 one, as K1 f32's
        k5_bound = 1000.0 * max(min(3 * 4 * n * n * d / PEAK_TF32,
                                    4 * n * n * d / PEAK_FP32),
                                3 * n * d * 4 / HBM_BYTES_S)
        k5_ms = cuda_ms(lambda: kernels.mean_shift_step(m5, embn, inv2b2), 5)
        k5_plain = cuda_ms(lambda: kernels.mean_shift_step_plain(
            m5, embn, inv2b2), 5)
        k5_lib = cuda_ms(lambda: sdpa_mean_shift(embn, bw_f, 1, m5), 5)
        print(f"[6 times] K5 10000x128 one step: kernel {k5_ms:.3f} ms, "
              f"plain {k5_plain:.3f} ms, SDPA step {k5_lib:.3f} ms, bound "
              f"{k5_bound:.3f} ms (operations)", flush=True)
        entries.append({
            "name": "ms_step", "route": "cuda",
            "source": "parsenet_tpu_torch/csrc/ms_iterations_tf32.cu",
            "replaces": "parsenet_tpu/ops/pallas_kernels.py:83",
            "launches": launches["K5"] + train_l["K5"],
            "max_abs_err": report.get("K5_max_abs_err"),
            "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
            "bound_by": "operations", "library_ms": k5_lib, "id": "K5"})

    phase(kernel_times)
    # phase 9's and phase 10's launches, counted from zero around each of
    # their drives
    p9 = report.get("dp", {}).get("launches", {})
    p10 = report.get("finetune", {}).get("launches", {})
    for entry in entries:
        key = str(entry.get("id", "")).replace(" ", "_")
        entry["launches_phase9"] = p9.get(key, 0)
        entry["launches_phase10"] = p10.get(key, 0)
        entry["launches"] += p9.get(key, 0) + p10.get(key, 0)
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
