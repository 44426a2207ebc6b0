"""parallel.launch.lead, the mode whose caller is rank 0, and the
segmentation step at 4 gloo ranks under it.

The launcher: ranks 1..W-1 are spawned processes (the spawn start method,
a FileStore under tmp_path, one torch thread a rank, a 120 s deadline)
and this test process is rank 0. Their results come back in rank order, a
failed rank's traceback is raised here, ranks are killed past the
deadline, and they exit by themselves when the process that led them is
killed.

The step: train_seg.make_step_fns under the 4-rank mesh, each rank holding
its slice of the global batch (parallel.mesh.shard_batch, as the trainer
and the benchmark's normals-train-4card cell feed it), 3 Adam steps from
seeded random weights at a tiny size, held against the benchmark's plain
one-process reference of the global batch
(benchmark/reference/train.seg_steps) by the cell's own numbers
(benchmark/reference/compare.training_gaps). Limits: a tenth of the cell's
(benchmark/workloads/normals-train-4card.json); the CPU's f32 sums over
4 ranks read 0 (first loss), 1.1e-7 (the 3 losses), 7.3e-8 (gradient) and
3.6e-7 (change). rank_gap, the largest difference of any parameter of
ranks 1-3 from rank 0's after the steps, is 0: gloo's all-reduce hands
every rank the same sum. With the gradient all-reduce skipped (each rank steps on its
own slice's gradient) the gradient and the replicas part by far more.
"""
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.parallel import launch

torch.set_num_threads(1)

DEADLINE = 120.0
ROOT = Path(__file__).resolve().parent.parent
A, B, N, K = 3, 4, 64, 16      # micro-batches, global shapes each, points, k


def _rank_sum(mesh, tag):
    total = mesh.all_sum(torch.tensor([float(mesh.rank)]))
    return tag, mesh.rank, float(total)


def _rank_fails(mesh):
    if mesh.rank == 2:
        raise ValueError("rank 2 failed on purpose")
    return mesh.rank


def _rank_hangs(mesh):
    time.sleep(600)


def test_lead_returns_the_ranks_results_in_rank_order(tmp_path):
    with launch.lead(_rank_sum, 4, ("t",), device="cpu", deadline=DEADLINE,
                     store_dir=str(tmp_path)) as ranks:
        assert (ranks.mesh.rank, ranks.mesh.world) == (0, 4)
        total = float(ranks.mesh.all_sum(torch.tensor([0.0])))
        got = ranks.join()
    assert got == [("t", r, 6.0) for r in (1, 2, 3)] and total == 6.0
    assert not torch.distributed.is_initialized()


def test_lead_raises_a_failed_ranks_traceback(tmp_path):
    with launch.lead(_rank_fails, 3, device="cpu", deadline=DEADLINE,
                     store_dir=str(tmp_path)) as ranks:
        procs = list(ranks.procs)
        with pytest.raises(RuntimeError, match="rank 2 failed on purpose"):
            ranks.join()
    assert not any(p.is_alive() for p in procs)
    assert not torch.distributed.is_initialized()


def test_lead_kills_its_ranks_past_the_deadline(tmp_path):
    t0 = time.monotonic()
    with launch.lead(_rank_hangs, 3, device="cpu", deadline=10.0,
                     store_dir=str(tmp_path)) as ranks:
        procs = list(ranks.procs)
        with pytest.raises(TimeoutError):
            ranks.join()
    assert not any(p.is_alive() for p in procs)
    assert time.monotonic() - t0 < 60


CALLER = r'''
import sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(1)
from parsenet_tpu_torch.parallel import launch
from test_torch_dp_lead import _rank_hangs
ranks = launch.lead(_rank_hangs, 3, device="cpu", deadline=120.0,
                    store_dir=sys.argv[3])
print(" ".join(str(p.pid) for p in ranks.procs), flush=True)
time.sleep(600)
'''


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return any(line.split()[:2] == ["State:", "Z"] for line in f)
    except FileNotFoundError:
        return True


def test_lead_ranks_exit_when_their_caller_is_killed(tmp_path):
    caller = subprocess.Popen(
        [sys.executable, "-c", CALLER, str(ROOT), str(ROOT / "tests"),
         str(tmp_path)], stdout=subprocess.PIPE, text=True)
    try:
        pids = [int(p) for p in caller.stdout.readline().split()]
        assert len(pids) == 2 and not any(_gone(p) for p in pids)
    finally:
        caller.send_signal(signal.SIGKILL)
        caller.wait()
    end = time.monotonic() + 30
    while time.monotonic() < end and not all(_gone(p) for p in pids):
        time.sleep(0.2)
    assert all(_gone(p) for p in pids)


# --- the segmentation step at 4 ranks ----------------------------------------

def _config():
    with open(ROOT / "benchmark" / "configs" / "parsenet_normals_dp4.json") as f:
        cfg = json.load(f)
    cfg["network"]["k"] = K
    return cfg


def _batches(steps: int):
    from parsenet_tpu_torch.data.synthetic import make_shape_batch
    rng = np.random.RandomState(11)
    return [make_shape_batch(rng, A * B, N, min_segments=2, max_segments=5)
            for _ in range(steps)]


def _seg_run(mesh, cfg, batches, seed, skip_all_reduce):
    """3 steps of the seg step on this rank's slices -> what the check
    reads (losses, the first gradient's and the change's norms a leaf) and
    the parameters flattened; then the dp.* spans of one more step and of
    a gather_batch under torch.profiler."""
    from parsenet_tpu_torch.losses.embedding import draw_triplet
    from parsenet_tpu_torch.models import dgcnn
    from parsenet_tpu_torch.parallel.mesh import (gather_batch, replicate,
                                                  shard_batch)
    from parsenet_tpu_torch.train import state, train_seg
    net, lr = cfg["network"], float(cfg["training"]["lr"])
    model = dgcnn.PrimitivesEmbedding(
        emb_size=net["emb_size"], num_primitives=net["num_primitives"],
        mode=net["mode"], k=net["k"])
    dgcnn.init_flax_like(model, torch.Generator().manual_seed(seed))
    replicate(mesh, model)
    opt = state.make_optimizer(model.parameters(), "adam", lr)
    if skip_all_reduce:
        mesh.all_reduce_grads = lambda params: None
    train_step, _ = train_seg.make_step_fns(model, opt, mesh)
    gen = torch.Generator().manual_seed(seed + 1)
    named = list(model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in named}

    def step(b):
        pts, labels, normals, prim = b
        x = torch.from_numpy(np.concatenate([pts, normals], -1))
        u_pts, u_pairs = draw_triplet(A * B, gen, torch.device("cpu"))
        return train_step(*(shard_batch(
            mesh, t.reshape(A, B, *t.shape[1:]), axis=1) for t in (
                x, torch.from_numpy(labels).long(),
                torch.from_numpy(prim).long(), u_pts, u_pairs)), lr)

    losses, grad = [], {}
    for i, b in enumerate(batches):
        m = step(b)
        losses.append(float(m["embed_loss"] + m["prim_loss"]))
        if i == 0:
            grad = {k: float(torch.linalg.norm(
                opt.state[p]["exp_avg"].double())) / (1.0 - 0.9)
                for k, p in named}
    change = {k: float(torch.linalg.norm((p.detach() - p0[k]).double()))
              for k, p in named}
    flat = torch.cat([p.detach().reshape(-1) for _, p in named]).numpy()
    spans = {}
    if not skip_all_reduce:
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            step(batches[0])
            rows = gather_batch(mesh, torch.ones(2, 3, requires_grad=True))
            rows.sum().backward()
        for e in prof.events():
            if e.name.startswith("dp."):
                spans[e.name] = spans.get(e.name, 0) + 1
    return ({"losses": losses, "grad": grad, "change": change}, flat, spans)


def _seg_rank(mesh, cfg, batches, seed):
    """The sound run, then the run with the gradient all-reduce skipped."""
    sound = _seg_run(mesh, cfg, batches, seed, False)
    return sound, _seg_run(mesh, cfg, batches, seed, True)


def _gaps(cfg, batches, outs):
    from benchmark.reference import compare
    from benchmark.reference.train import seg_steps
    ref = seg_steps(cfg, batches, torch.Generator().manual_seed(6), A, B, 5,
                    float(cfg["training"]["lr"]), torch.device("cpu"))
    gaps = compare.training_gaps(outs[0][0], ref)
    gaps["rank_gap"] = max(float(np.abs(o[1] - outs[0][1]).max())
                           for o in outs[1:])
    return gaps


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """{sound, fault: (the check's numbers against the reference, each
    rank's spans)} of one 4-rank group; the cell's limits."""
    cfg, batches = _config(), _batches(3)
    args = (cfg, batches, 5)
    with launch.lead(_seg_rank, 4, args, device="cpu", deadline=DEADLINE,
                     store_dir=str(tmp_path_factory.mktemp("store"))) as r:
        outs = [_seg_rank(r.mesh, *args)] + r.join()
    with open(ROOT / "benchmark" / "workloads" /
              "normals-train-4card.json") as f:
        limits = json.load(f)["limits"]
    return {name: (_gaps(cfg, batches, [o[i] for o in outs]),
                   [o[i][2] for o in outs])
            for i, name in enumerate(("sound", "fault"))}, limits


def test_seg_step_at_four_ranks_is_the_references_step_of_the_global_batch(
        four_ranks):
    runs, limits = four_ranks
    gaps, spans = runs["sound"]
    assert set(limits) == {"first_loss_gap", "loss_gap", "grad_gap",
                           "change_gap", "rank_gap"}
    assert gaps["rank_gap"] == 0.0, gaps
    for k in ("first_loss_gap", "loss_gap", "grad_gap", "change_gap"):
        assert gaps[k] <= limits[k] / 10, (k, gaps)
    # one span a collective: a step's 3 triplet normalisers (one a
    # micro-batch), its gradient all-reduce and its metrics' mean; the
    # gather's forward and backward
    for s in spans:
        assert s == {"dp.all_sum": A, "dp.all_reduce_grads": 1,
                     "dp.all_mean": 1, "dp.gather_rows": 2}, s


def test_skipped_gradient_all_reduce_trips_the_check(four_ranks):
    runs, limits = four_ranks
    gaps = runs["fault"][0]
    assert gaps["grad_gap"] > limits["grad_gap"], gaps
    assert gaps["rank_gap"] > limits["rank_gap"], gaps
