"""Pretraining the segmentation network data-parallel over mix["ranks"]
ranks, one a card: the step of seg_train_step,
train.train_seg.make_step_fns(model, optimizer, mesh).train_step, under the
parallel.mesh.Mesh of a group made by parallel.launch.lead.

This process is rank 0 on the harness's card (cuda:0); start() spawns ranks
1..W-1 on cuda:1..W-1 (`follow`). Every rank builds the same pool, point
subsample RandomState, device generator and seeded weights (broadcast from
rank 0 by parallel.mesh.replicate, as the trainer does), draws every
global batch and keeps its slice (parallel.mesh.shard_batch, as the
trainer does). Each step's collectives hold the ranks together: a rank's
host waits on the step's own syncs, which wait on the step's collectives,
so no rank starts step k + 1 before every rank has started step k. The
ranks follow rank 0's steps without a host sync or a collective beyond
the step's own: each reads a stop value in shared memory before a step.
release() posts stop = (rank 0's steps) + 1, runs that one step that a
rank may have begun before reading the value, outside the window, and
joins the ranks, so none is left in a collective.

The check: rank 0's recorded steps (seg_train_step's numbers, the global
batches' losses, first gradient and change) against the one-process
reference of the global batches, and rank_gap: after the checked steps
(set-up) the ranks' parameters are gathered once and rank 0 reads the
largest absolute difference of any of ranks 1..W-1 from its own.
`skip_all_reduce`, set on the class before start(), is the planted fault
of the check's readings and tests (each rank steps on its own slice's
gradient); benchmark/run.py never sets it.
"""
from __future__ import annotations

import importlib
import multiprocessing as mp

import torch

from benchmark import harness
from benchmark.cells import CHECKED_STEPS, TrainingDriver
from benchmark.counts import dp as dp_counts
from benchmark.loops import NoClock

_seg = harness.load_module("drivers", "seg_train_step")

# seconds ranks 1..W-1 may live: set-up, a window, the profiled stretch
DEADLINE = 1200.0


def rank_gap(mesh, model) -> float:
    """The largest absolute difference of any parameter of ranks 1..W-1
    from rank 0's: the flattened parameters gathered once (every rank
    calls it at the same point)."""
    from parsenet_tpu_torch.parallel.mesh import gather_batch
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in model.parameters()])
        rows = gather_batch(mesh, flat[None])
        return float((rows[1:] - rows[:1]).abs().max())


class Driver(_seg.Driver):

    skip_all_reduce = False

    def load_program(self):
        super().load_program()
        from parsenet_tpu_torch.parallel import launch, mesh
        self.launch, self.mesh_ops = launch, mesh
        self.world = int(self.mix["ranks"])
        self.ranks = None

    def start(self, seeds):
        self.stop_ranks()
        self.stop = mp.get_context("spawn").RawValue("q", -1)
        follow = importlib.import_module(
            "benchmark.drivers.seg_train_step_dp").follow
        self.ranks = self.launch.lead(
            follow, self.world, (self.cell, seeds, self.stop,
                                 self.skip_all_reduce),
            device=self.dev, deadline=DEADLINE)
        self.on_mesh(self.ranks.mesh, seeds)

    def on_mesh(self, mesh, seeds):
        """This rank's state on `mesh` (TrainingDriver.start)."""
        self.mesh, self.steps = mesh, 0
        TrainingDriver.start(self, seeds)

    def build(self, seeds):
        super().build(seeds)
        _, _, train_seg, draw_triplet = self.prog
        mesh, shard = self.mesh, self.mesh_ops.shard_batch
        self.mesh_ops.replicate(mesh, self.model)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        if self.skip_all_reduce:
            mesh.all_reduce_grads = lambda params: None
        train_step, _ = train_seg.make_step_fns(self.model, self.optimizer,
                                                mesh)
        a, b = self.accum, self.batch

        def step_fn(x, labels, prim):
            u_pts, u_pairs = draw_triplet(a * b, self.gen, self.dev)
            return train_step(*(shard(mesh, t.reshape(a, b, *t.shape[1:]),
                                      axis=1)
                                for t in (x, labels, prim, u_pts, u_pairs)),
                              self.lr, self.timer)
        self.step_fn = step_fn

    def enqueue(self, i):
        self.steps += 1
        return super().enqueue(i)

    def warm(self):
        super().warm()
        self.recorded["rank_gap"] = rank_gap(self.mesh, self.model)

    def stop_ranks(self) -> None:
        """Post the stop, run the step a rank may owe, join and close the
        ranks (nothing where none run)."""
        if self.ranks is None:
            return
        try:
            self.stop.value = self.steps + 1
            self.timer = NoClock()
            self.enqueue(self.steps)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            for out in self.ranks.join():
                harness.say(f"rank {out['rank']}: {out['steps']} steps, "
                            f"memory_peak_bytes {out['memory_peak_bytes']}")
        finally:
            self.ranks.close()
            self.ranks = None

    def release(self):
        self.stop_ranks()
        super().release()

    def compare(self, prog, ref):
        out = super().compare(prog, ref)
        if "rank_gap" in prog and "rank_gap" in self.cell.limits:
            out["rank_gap"] = prog["rank_gap"]
        return out

    def unit_counts(self):
        return dict(super().unit_counts(), chips=self.world,
                    collective_bytes=dp_counts.seg_step_allreduce_bytes(
                        self.n_params, self.accum))


def follow(mesh, cell, seeds, stop, skip_all_reduce) -> dict:
    """Rank 1..W-1: the driver on this rank's card, stepping until the
    stop value (read before each step) is reached; the rank_gap gather
    after the checked steps, as rank 0's warm() makes it. Fails where the
    rank loaded a module of harness.FORBIDDEN."""
    drv = Driver(cell, mesh.device)
    drv.skip_all_reduce = skip_all_reduce
    drv.on_mesh(mesh, seeds)
    k = 0
    while stop.value < 0 or k < stop.value:
        drv.enqueue(k)
        k += 1
        if k == CHECKED_STEPS:
            rank_gap(mesh, drv.model)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    found = harness.forbidden_modules()
    if found:
        raise RuntimeError(f"rank {mesh.rank} loaded forbidden modules: "
                           f"{found}")
    return {"rank": mesh.rank, "steps": k, "memory_peak_bytes": int(
        torch.cuda.max_memory_allocated(mesh.device) if cuda else 0)}
