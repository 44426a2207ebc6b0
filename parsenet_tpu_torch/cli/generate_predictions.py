"""Segmentation inference over the test split (the port's counterpart of
the root generate_predictions.py).

    python -m parsenet_tpu_torch.cli.generate_predictions \\
        configs/config_parsenet_normals.yml [out.h5] [--device cuda]

Reads the weights the port's trainer saves, {log_dir}/checkpoints/
{model_path}.npz, and the config's test split ({dataset}test_data.h5, with
val_data.h5 beside it), segments every shape in batches of 4 (mode 5:
points and normals; mode 0: points) with the library's f32 mean-shift,
logs each shape's SIOU and their mean, and writes seg_id [S, N] and
pred_primitives [S, N] (int32) to out.h5 (default {log_dir}/
predictions.h5), the layout the root test.py and cli.test read.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..core.config import load_config
from ..core.guards import entry_device
from ..core.logging import setup_logging
from ..core.profiling import StepTimer, trace
from ..eval.pipeline import predict_segmentation
from ..models.dgcnn import load_primitives_embedding

log = logging.getLogger("parsenet_tpu_torch")
BATCH = 4


def load_model(cfg, device=None):
    """The segmentation network of {log_dir}/checkpoints/{model_path}.npz
    at the config's mode and k; a missing file raises."""
    path = os.path.join(cfg.log_dir, "checkpoints", f"{cfg.model_path}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no checkpoint at {path}: the port reads the flat npz its "
            "trainers save; an orbax checkpoint of the JAX package is "
            "exported to that layout by scripts/export_params.py")
    return load_primitives_embedding(path, mode=5 if cfg.mode == 5 else 0,
                                     k=cfg.knn_k, device=device)


@torch.no_grad()
def predict_split(model, points, normals, labels, prim,
                  generator: torch.Generator, batch_size: int = BATCH,
                  device=None, timer: StepTimer = None) -> dict:
    """Segment S shapes, points / normals [S, N, 3], labels / prim [S, N],
    in batches of `batch_size` (a short tail batch is padded by repeating
    its last shape, and the padding's results dropped), every draw from
    `generator`. Returns {"seg_id": [S, N] int32, "pred_primitives":
    [S, N] int32, "seg_iou": [S], "prim_iou": [S], "num_clusters": [S]}."""
    dev = entry_device(device)
    n_shapes = len(points)
    out = {k: [] for k in ("seg_id", "pred_primitives", "seg_iou",
                           "prim_iou", "num_clusters")}
    for start in range(0, n_shapes, batch_size):
        sel = list(range(start, min(start + batch_size, n_shapes)))
        n = len(sel)
        sel += [sel[-1]] * (batch_size - n)
        if timer is not None:
            timer.start()
        with trace("predict_batch"):
            pred = predict_segmentation(
                model, points[sel], normals[sel], labels[sel], prim[sel],
                generator=generator, device=dev)
        if timer is not None:
            timer.stop(dev)
        out["seg_id"] += list(pred.labels[:n].cpu().numpy().astype(np.int32))
        out["pred_primitives"] += list(
            pred.pred_prim[:n].cpu().numpy().astype(np.int32))
        out["seg_iou"] += pred.seg_iou[:n].tolist()
        out["prim_iou"] += pred.prim_iou[:n].tolist()
        out["num_clusters"] += list(pred.num_clusters[:n])
        for j in range(n):
            log.info("shape %d: seg iou %.4f prim iou %.4f clusters %d",
                     start + j, out["seg_iou"][start + j],
                     out["prim_iou"][start + j],
                     out["num_clusters"][start + j])
    for k in ("seg_id", "pred_primitives"):
        out[k] = np.stack(out[k])
    return out


def write_predictions(path: str, pred: dict) -> None:
    import h5py
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("seg_id", data=pred["seg_id"])
        hf.create_dataset("pred_primitives", data=pred["pred_primitives"])


def load_test_split(cfg):
    """The config's test split as arrays (points, labels, normals, prim),
    each shape centred and aligned as the JAX entry points read it."""
    from ..data.abc import ABCDataset
    ds = ABCDataset(1, path_prefix=cfg.dataset or "data/shapes/",
                    val_size=cfg.num_val or None,
                    test_size=cfg.num_test or None, if_train_data=False)
    return tuple(np.concatenate(a) for a in zip(*ds.get_test()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Segment the test split and write predictions.h5.")
    ap.add_argument("config", help="configs/config_parsenet*.yml")
    ap.add_argument("out", nargs="?", default=None,
                    help="output h5 (default {log_dir}/predictions.h5)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    dev = entry_device(args.device)
    setup_logging(cfg.log_dir, "generate_predictions")
    model = load_model(cfg, dev)
    points, labels, normals, prim = load_test_split(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    timer = StepTimer(skip_first=1)
    pred = predict_split(model, points, normals, labels, prim, gen,
                         device=dev, timer=timer)
    log.info("MEAN seg iou %.4f prim iou %.4f; %.2f ms a batch of %d",
             np.mean(pred["seg_iou"]), np.mean(pred["prim_iou"]),
             1000.0 * timer.summary()["mean_s"], BATCH)
    out = args.out or os.path.join(cfg.log_dir, "predictions.h5")
    write_predictions(out, pred)
    log.info("wrote %s", out)
    return pred


if __name__ == "__main__":
    main()
