"""The test protocol a request: eval.pipeline.batch_metrics, the entry the
port's cli.bench drives (network, mean-shift, SIOU matching, the fits and
surface samples, the spline slots, the residual and the coverage), with
the configuration's mean-shift precision and its spline decoders; the
per-shape results of METRICS are fetched one request behind."""
from __future__ import annotations

import torch

from benchmark import counts
from benchmark.cells import InferenceDriver
from benchmark.reference import infer as ref_infer
from benchmark.harness import ROOT


class Driver(InferenceDriver):

    def load_program(self):
        from parsenet_tpu_torch.core.guards import entry_device
        from parsenet_tpu_torch.eval.pipeline import METRICS, batch_metrics
        from parsenet_tpu_torch.fitting.spline_apply import build_spline_fit
        from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
        from parsenet_tpu_torch.ops import kernels
        entry_device(self.dev)
        if self.dev.type == "cuda":
            kernels.build_kernels()
        net, sl = self.cfg["network"], self.cfg["spline_slots"]
        self.columns, self.entry = METRICS, batch_metrics
        self.ms_bf16 = (self.cfg["precision"]["mean_shift"]["test_protocol"]
                        == "bfloat16")
        self.net = ref_infer.Recorder(load_primitives_embedding(
            self.weights["network"], mode=net["mode"], k=net["k"],
            emb_size=net["emb_size"], num_primitives=net["num_primitives"],
            device=self.dev))
        self.program = build_spline_fit(
            grid=sl["grid"], sample_grid=sl["sample_grid"],
            params_dir=str(ROOT / self.cfg["spline_params_dir"]),
            device=self.dev)

    def call(self, i, batch):
        pts, labels, normals, prim = batch
        out = self.entry(self.net, pts, normals, labels, prim,
                         self.generator(i), ms_bf16=self.ms_bf16,
                         spline_fit=self.program, device=self.dev,
                         timer=self.timer)
        return (torch.stack([out[k] for k in self.columns], dim=1),
                {"k": out["num_clusters"]})

    def load_reference(self):
        self.ref = (ref_infer.network(self.cfg, self.weights["network"],
                                      self.dev),
                    ref_infer.spline_decoders(
                        self.cfg, str(ROOT / self.cfg["spline_params_dir"]),
                        self.dev))

    def reference_call(self, i, batch):
        vals, net, k = ref_infer.protocol(
            *self.ref, batch, (self.seeds["torch"] + i) % (1 << 63),
            self.ms_bf16, self.dev)
        return None, vals, {"net": net, "k": k}

    def unit_counts(self):
        n, cfg = int(self.mix["points"]), self.cfg
        return {"flops_per_shape": counts.protocol_flops_per_shape(cfg, n),
                "mean_shift": counts.mean_shift_counts(
                    n, cfg["network"]["emb_size"],
                    cfg["mean_shift"]["iterations"])}
