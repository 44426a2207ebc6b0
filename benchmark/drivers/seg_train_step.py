"""Pretraining the segmentation network a step: train.train_seg.
make_step_fns(...).train_step (the triplet and type losses over the
micro-batches, their gradients averaged and guarded, one Adam step) from
the seeded initialisation, fed as train_seg feeds it: the shapes behind
data.prefetch.lookahead, each step's point subsample by
train.state.pack_batch and its triplet draws by losses.embedding.
draw_triplet."""
from __future__ import annotations

import torch

from benchmark import counts
from benchmark.cells import CHECKED_STEPS, TrainingDriver
from benchmark.reference import train as ref_train


class Driver(TrainingDriver):

    def load_program(self):
        from parsenet_tpu_torch.core.guards import entry_device
        from parsenet_tpu_torch.data.prefetch import lookahead
        from parsenet_tpu_torch.losses.embedding import draw_triplet
        from parsenet_tpu_torch.models import dgcnn
        from parsenet_tpu_torch.train import state, train_seg
        entry_device(self.dev)
        self.lookahead, self.pack_batch = lookahead, state.pack_batch
        self.prog = (dgcnn, state, train_seg, draw_triplet)
        self.lr = float(self.cfg["training"]["lr"])

    def build(self, seeds):
        dgcnn, state, train_seg, draw_triplet = self.prog
        net = self.cfg["network"]
        model = dgcnn.PrimitivesEmbedding(
            emb_size=net["emb_size"], num_primitives=net["num_primitives"],
            mode=net["mode"], k=net["k"])
        dgcnn.init_flax_like(model, torch.Generator().manual_seed(
            seeds["init"]))
        self.model = model.to(self.dev)
        self.optimizer = state.make_optimizer(self.model.parameters(),
                                              "adam", self.lr)
        train_step, _ = train_seg.make_step_fns(self.model, self.optimizer)
        a, b = self.accum, self.batch

        def step_fn(x, labels, prim):
            u_pts, u_pairs = draw_triplet(a * b, self.gen, self.dev)
            return train_step(*(t.reshape(a, b, *t.shape[1:]) for t in (
                x, labels, prim, u_pts, u_pairs)), self.lr, self.timer)
        self.step_fn = step_fn

    def loss_of(self, m):
        return m["embed_loss"] + m["prim_loss"]

    def reference_steps(self, half=False):
        batches, gen = self.step_inputs()
        return ref_train.seg_steps(self.cfg, batches[:CHECKED_STEPS], gen,
                                   self.accum, self.batch,
                                   self.seeds["init"], self.lr, self.dev, half)

    def unit_counts(self):
        return {"flops_per_shape": counts.seg_train_flops_per_shape(
            self.cfg, self.keep)}
