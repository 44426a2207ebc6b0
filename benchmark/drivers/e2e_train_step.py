"""Fine-tuning through the fitting loss a step: train.train_e2e.
make_e2e_step(...).train_step (the network, mean-shift with K1 f32
attempts and the accepted bandwidth re-run with autograd, matching, the
fits, the frozen SplineNets, the slots' chamfer, the gradients averaged
over the micro-batches and guarded, one Adam step) from the shipped e2e
weights, fed as train_e2e feeds it: the shapes behind
data.prefetch.lookahead, each step's point subsample by
train.state.pack_batch and each micro-batch's draws by
train_e2e.draw_e2e."""
from __future__ import annotations

from benchmark import counts
from benchmark.cells import CHECKED_STEPS, TrainingDriver
from benchmark.harness import ROOT
from benchmark.reference import train as ref_train


class Driver(TrainingDriver):

    def load_program(self):
        from parsenet_tpu_torch.core.guards import entry_device
        from parsenet_tpu_torch.data.prefetch import lookahead
        from parsenet_tpu_torch.fitting.spline_apply import build_spline_fit
        from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
        from parsenet_tpu_torch.ops import kernels
        from parsenet_tpu_torch.train import state, train_e2e
        entry_device(self.dev)
        if self.dev.type == "cuda":
            kernels.build_kernels()
        self.lookahead, self.pack_batch = lookahead, state.pack_batch
        self.prog = (load_primitives_embedding, build_spline_fit, state,
                     train_e2e)
        self.tr = self.cfg["e2e_training"]
        self.lr = float(self.tr["lr"])
        self.params_dir = str(ROOT / self.cfg["spline_params_dir"])

    def build(self, seeds):
        load_net, build_fit, state, train_e2e = self.prog
        net, sl, tr = (self.cfg["network"], self.cfg["spline_slots"],
                       self.tr)
        self.model = load_net(self.weights["network"], mode=net["mode"],
                              k=net["k"], emb_size=net["emb_size"],
                              num_primitives=net["num_primitives"],
                              device=self.dev).train()
        fit = build_fit(grid=sl["grid"], sample_grid=sl["sample_grid"],
                        params_dir=self.params_dir, device=self.dev)
        self.optimizer = state.make_optimizer(self.model.parameters(),
                                              "adam", self.lr)
        train_step, _ = train_e2e.make_e2e_step(
            self.model, fit, self.optimizer, quantile=tr["quantile"],
            iterations=tr["iterations"], lamb=tr["lamb"],
            ms_num_samples=tr["subset"], spline_stride=tr["spline_stride"])
        a, b = self.accum, self.batch

        def step_fn(x, labels, prim):
            draws = [train_e2e.draw_e2e(b, x.shape[1], tr["subset"],
                                        self.gen, self.dev)
                     for _ in range(a)]
            return train_step(*(t.reshape(a, b, *t.shape[1:]) for t in (
                x, labels, prim)), draws, self.lr, self.timer)
        self.step_fn = step_fn

    def loss_of(self, m):
        return m["embed_loss"] + m["prim_loss"] + m["res_loss"]

    def reference_steps(self, half=False):
        batches, gen = self.step_inputs()
        return ref_train.e2e_steps(self.cfg, batches[:CHECKED_STEPS], gen,
                                   self.accum, self.batch,
                                   self.weights["network"], self.params_dir,
                                   self.lr, self.dev, half)

    def unit_counts(self):
        return {"flops_per_shape": counts.e2e_train_flops_per_shape(
                    self.cfg, self.keep),
                "mean_shift": counts.mean_shift_counts(
                    self.keep, self.cfg["network"]["emb_size"],
                    self.tr["iterations"])}
