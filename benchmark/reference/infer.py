"""The reference's inference: the network, the clustering, the matching and
the test protocol's reconstruction of a request, from the inputs the
benchmark made (the shapes, the weight files and the request's generator
seed, from which every draw is made again on the same device)."""
from __future__ import annotations

import torch

from .plain.core.checkpoint import load_npz_params
from .plain.eval import pipeline
from .plain.fitting.spline_apply import build_spline_fit
from .plain.models.dgcnn import PrimitivesEmbedding, params_from_jax


class Recorder(torch.nn.Module):
    """A network whose outputs are kept while `keep` is set: what the
    comparison reads of the program's and the reference's networks."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.keep = False
        self.outputs = []

    def forward(self, x):
        out = self.model(x)
        if self.keep:
            self.outputs.append(tuple(t.detach() for t in out))
        return out


def network(cfg: dict, weights: str, dev) -> PrimitivesEmbedding:
    """The configuration's PrimitivesEmbedding with the weights of the npz
    at `weights`, in eval mode on `dev`."""
    net = cfg["network"]
    model = PrimitivesEmbedding(emb_size=net["emb_size"],
                                num_primitives=net["num_primitives"],
                                mode=net["mode"], k=net["k"])
    model.load_state_dict(params_from_jax(load_npz_params(weights), model))
    return model.to(dev).eval()


def spline_decoders(cfg: dict, params_dir: str, dev):
    sl = cfg["spline_slots"]
    return build_spline_fit(grid=sl["grid"], sample_grid=sl["sample_grid"],
                            params_dir=params_dir, device=dev)


def _generator(seed: int, dev) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


@torch.no_grad()
def protocol(model, fit, batch, seed: int, ms_bf16: bool, dev):
    """One request of the test protocol -> ([B, len(METRICS)] per-shape
    results, (embedding, type log-probs), [B] cluster counts)."""
    rec = Recorder(model)
    rec.keep = True
    pts, labels, normals, prim = batch
    out = pipeline.batch_metrics(rec, pts, normals, labels, prim,
                                 _generator(seed, dev), ms_bf16=ms_bf16,
                                 spline_fit=fit, device=dev)
    vals = torch.stack([out[k] for k in pipeline.METRICS], dim=1)
    return vals.cpu().numpy(), rec.outputs[0], list(out["num_clusters"])


@torch.no_grad()
def segment(model, batch, seed: int, cfg: dict, dev):
    """One request of generate_predictions -> ([B, 2] seg and type IoU,
    (embedding, type log-probs))."""
    rec = Recorder(model)
    rec.keep = True
    pts, labels, normals, prim = batch
    ms = cfg["mean_shift"]
    pred = pipeline.predict_segmentation(
        rec, pts, normals, labels, prim, quantile=ms["quantile"],
        iterations=ms["iterations"], ms_num_samples=ms["subset"],
        generator=_generator(seed, dev), device=dev)
    vals = torch.stack([pred.seg_iou, pred.prim_iou], dim=1)
    return vals.cpu().numpy(), rec.outputs[0]
