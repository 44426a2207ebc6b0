"""Retraining the closed SplineNet a step: train.train_spline.make_fed_step
(the next batch of the feed, the step's point count drawn from the
buckets by the trainer's own RandomState, the copies to the card, then
make_train_step's step: the network in training mode, the 80-symmetry
regression and the one-sided chamfer on K3, the backward with K4, one
Adam step) from the seeded initialisation, fed as train_spline feeds it:
data.splines.SplineDataset over the pool's patches (split, shuffle,
canonicalisation, augmentation) behind data.prefetch.lookahead."""
from __future__ import annotations

import numpy as np

from benchmark.cells import CHECKED_STEPS, TrainingDriver
from benchmark.counts import spline as spline_counts
from benchmark.loops import NoClock
from benchmark.patches import PatchPool
from benchmark.reference import train_spline as ref_spline


class Driver(TrainingDriver):

    def __init__(self, cell, dev):
        self.cell, self.dev = cell, dev
        self.cfg, self.mix = cell.config, cell.mix
        self.net, self.tr = self.cfg["network"], self.cfg["training"]
        self.shapes = int(self.mix["batch"])
        self.buckets = tuple(int(n) for n in self.mix["point_buckets"])
        self.timer = NoClock()
        self.pool = None
        self.load_program()

    def load_program(self):
        from parsenet_tpu_torch.core.config import Config
        from parsenet_tpu_torch.core.guards import entry_device
        from parsenet_tpu_torch.data.prefetch import lookahead
        from parsenet_tpu_torch.data.splines import SplineDataset
        from parsenet_tpu_torch.ops import kernels
        from parsenet_tpu_torch.train.train_spline import (make_fed_step,
                                                           make_trainer)
        entry_device(self.dev)
        if self.dev.type == "cuda":
            kernels.build_kernels()
        self.prog = (Config, lookahead, SplineDataset, make_fed_step,
                     make_trainer)
        self.lr = float(self.tr["lr"])

    def start(self, seeds):
        """The pool (made once, the mix's), the trainer's feed over it from
        seeds["pool"], its point counts from seeds["subsample"], the
        network from seeds["init"]."""
        _, lookahead, dataset, make_fed_step, _ = self.prog
        self.seeds = seeds
        if self.pool is None:
            self.pool = PatchPool(self.mix, self.net["grid"])
        self.pool.served = 0
        ds = dataset.from_arrays(self.pool.points, self.pool.cps,
                                 self.shapes, self.net["grid"],
                                 closed=bool(self.mix["closed"]),
                                 seed=seeds["pool"],
                                 splits=(self.pool.size, 0))
        self.feed = lookahead(ds.load_train_data(
            anisotropic=self.tr["anisotropic"], if_augment=True))
        self.host_rng = np.random.RandomState(seeds["subsample"])
        self.build(seeds)
        # each step's point count as the fed step drew it, for the FLOPs
        self.points = []
        self.step_fn = make_fed_step(self.train_step, self.feed,
                                     self.host_rng, self.buckets, self.dev,
                                     drawn=self.points)
        self.failed = 0
        self.next_index = 0

    def build(self, seeds):
        """The trainer's network, optimizer and step (train_spline.
        make_trainer), initialised from seeds["init"]."""
        config, _, _, _, make_trainer = self.prog
        cfg = config(grid_size=self.net["grid"], seed=seeds["init"],
                     optim=self.tr["optimizer"], lr=self.lr)
        self.model, self.optimizer, self.train_step, _ = make_trainer(
            cfg, self.net["mode"] == 1, self.tr["anisotropic"], self.dev)

    def enqueue(self, i: int):
        self.pool.served += self.shapes
        m = self.step_fn(self.lr, self.tr["loss_weight"], self.timer)
        return i, m["loss"]

    def fetch(self, handle):
        """The step's loss on the host; a step whose loss is not finite has
        failed (the trainer steps whatever its gradient)."""
        loss = float(handle[1])
        self.failed += int(not np.isfinite(loss))
        return loss

    def release(self):
        self.step_fn = self.train_step = self.feed = None
        super().release()

    def reference_steps(self, half=False):
        batches = ref_spline.step_batches(
            self.pool, self.shapes, CHECKED_STEPS, self.seeds["pool"],
            self.seeds["subsample"], self.buckets, self.tr["anisotropic"])
        return ref_spline.spline_steps(self.cfg, batches, self.seeds["init"],
                                       self.dev, half)

    def unit_counts(self):
        """FLOPs a patch over the window's steps: those after the checked
        steps and before the profiled stretch (loops.profiled_stretch: one
        step, then profiled_requests)."""
        tail = int(self.mix["profiled_requests"]) + 1
        window = self.points[CHECKED_STEPS:len(self.points) - tail]
        return {"flops_per_shape": spline_counts.spline_train_flops_per_shape(
            window, self.net["mode"] == 1, self.net["grid"])}
