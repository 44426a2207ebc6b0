"""generate_predictions a request: eval.pipeline.predict_segmentation with
its defaults (the per-batch call of cli.generate_predictions.predict_split):
network, mean-shift (K1 f32), SIOU matching; no reconstruction. The seg
and type IoU a shape are fetched one request behind."""
from __future__ import annotations

import torch

from benchmark import counts
from benchmark.cells import InferenceDriver
from benchmark.reference import infer as ref_infer


class Driver(InferenceDriver):

    def load_program(self):
        from parsenet_tpu_torch.core.guards import entry_device
        from parsenet_tpu_torch.eval.pipeline import predict_segmentation
        from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
        from parsenet_tpu_torch.ops import kernels
        entry_device(self.dev)
        if self.dev.type == "cuda":
            kernels.build_kernels()
        if self.cfg["precision"]["mean_shift"]["segmentation"] != "float32":
            raise ValueError("predict_segmentation: its default mean-shift "
                             "is float32")
        net = self.cfg["network"]
        self.entry = predict_segmentation
        self.columns = ("seg_iou", "prim_iou")
        self.net = ref_infer.Recorder(load_primitives_embedding(
            self.weights["network"], mode=net["mode"], k=net["k"],
            emb_size=net["emb_size"], num_primitives=net["num_primitives"],
            device=self.dev))

    def call(self, i, batch):
        pts, labels, normals, prim = batch
        pred = self.entry(self.net, pts, normals, labels, prim,
                          generator=self.generator(i), device=self.dev,
                          timer=self.timer)
        return torch.stack([pred.seg_iou, pred.prim_iou], dim=1), {}

    def load_reference(self):
        self.ref = ref_infer.network(self.cfg, self.weights["network"],
                                     self.dev)

    def reference_call(self, i, batch):
        vals, net = ref_infer.segment(
            self.ref, batch, (self.seeds["torch"] + i) % (1 << 63),
            self.cfg, self.dev)
        return None, vals, {"net": net}

    def unit_counts(self):
        n, cfg = int(self.mix["points"]), self.cfg
        return {"flops_per_shape": counts.segment_flops_per_shape(cfg, n),
                "mean_shift": counts.mean_shift_counts(
                    n, cfg["network"]["emb_size"],
                    cfg["mean_shift"]["iterations"])}
