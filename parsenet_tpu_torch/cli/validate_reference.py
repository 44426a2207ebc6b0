"""The real-data validation harness (the port's counterpart of
scripts/validate_reference.py): the two-stage evaluation protocol,
generate_predictions then test (cli.generate_predictions.predict_split,
cli.test.evaluate_split), over a config's test split, and a parity table
against expected metrics with a tolerance verdict a row.

    python -m parsenet_tpu_torch.cli.validate_reference \\
        [configs/config_eval_final.yml] [--num-shapes N] \\
        [--expected scripts/expected_reference_metrics.json] \\
        [--no-preprocess] [--tolerance 0.01] [--params NPZ] [--device cuda]

Columns (means over the shapes):
  seg_iou   Hungarian-matched relaxed segment IoU
  prim_iou  primitive-type accuracy over the matched segments
  residual  mean sqrt point-to-own-surface distance
  cov       two-sided sqrt chamfer, input <-> predicted surfaces (p_cov)
  sk_1      share of input points within 0.01 of a predicted surface
  sk_2      ... within 0.02
seg_iou, prim_iou, sk_1 and sk_2 pass at >= (1 - tolerance) x expected,
residual and cov at <= (1 + tolerance) x expected; the trained-quality
floors are configs/quality_floors.json's "validate" ones. The last line
is a JSON summary (n_shapes, rows, knn, floors_ok, floors_protocol).

Weights: --params (default $BENCH_PARAMS), which must exist and fit the
network; else {log_dir}/checkpoints/{model_path}.npz (the port's trainer
checkpoint or an export of it); else the shipped params/parsenet_e2e.npz.
Decoders: {log_dir}/checkpoints/{open,closed}_splinenet.npz where both
exist, else the shipped ones. kNN is exact (the only kind the port has;
--knn-recall takes "exact" alone). Reading the split needs h5py;
`validate_split` and `parity_table` take arrays instead.
"""
import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..core.config import load_config
from ..core.guards import entry_device
from ..fitting.spline_apply import trained_spline_fit
from ..models.dgcnn import load_primitives_embedding
from .generate_predictions import load_test_split, predict_split
from .test import evaluate_split

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXPECTED = os.path.join(REPO, "scripts", "expected_reference_metrics.json")
FLOORS = os.path.join(REPO, "configs", "quality_floors.json")
COLUMNS = ("seg_iou", "prim_iou", "residual", "cov", "sk_1", "sk_2")
LOWER_IS_BETTER = ("residual", "cov")


def _load(path: str, cfg, dev):
    """The network of the npz at `path`, or None where it is missing or
    does not fit (a warning says which)."""
    if not path or not os.path.exists(path):
        return None
    try:
        return load_primitives_embedding(path, mode=5 if cfg.mode == 5
                                         else 0, k=cfg.knn_k, device=dev)
    except (KeyError, ValueError, RuntimeError) as e:
        print(f"validate: WARNING {path} does not fit the network ({e}); "
              "ignoring", file=sys.stderr)
        return None


def load_weights(cfg, explicit: str = "", device=None):
    """(network, source) by the module docstring's order; SystemExit where
    an explicit file does not load or nothing does."""
    dev = entry_device(device)
    if explicit:
        model = _load(explicit, cfg, dev)
        if model is None:
            raise SystemExit(f"--params {explicit} missing or incompatible: "
                             "refusing to silently measure a different "
                             "model")
        return model, explicit
    for path in (os.path.join(cfg.log_dir, "checkpoints",
                              f"{cfg.model_path}.npz"),
                 os.path.join(REPO, "params", "parsenet_e2e.npz")):
        model = _load(path, cfg, dev)
        if model is not None:
            return model, path
    raise SystemExit(f"no checkpoint under {cfg.log_dir}/checkpoints/"
                     f"{cfg.model_path}.npz and no shipped export; train "
                     "first (cli.train_workflow)")


def validate_split(model, points, normals, labels, prim, spline_fit,
                   generator: Optional[torch.Generator] = None, draws=None,
                   eval_preprocess: bool = True, device=None) -> dict:
    """Both stages on S shapes (points / normals [S, N, 3], labels / prim
    [S, N], canonicalised as the test split reads them): predict_split's
    segmentation, then evaluate_split's fits and coverage of those
    predictions. draws: each shape's (uniforms, slot_uniforms) for
    evaluate_split, else made from `generator` after the segmentation's.
    Returns the per-shape lists of COLUMNS and the labels ("seg_id")."""
    dev = entry_device(device)
    pred = predict_split(model, points, normals, labels, prim, generator,
                         device=dev)
    rec = evaluate_split(points, normals, pred["seg_id"],
                         pred["pred_primitives"], spline_fit,
                         generator=generator, draws=draws,
                         eval_preprocess=eval_preprocess, device=dev)
    out = {"seg_iou": list(pred["seg_iou"]),
           "prim_iou": list(pred["prim_iou"]),
           "residual": rec["residual"], "cov": rec["p_cov"],
           "sk_1": rec["sk_1"], "sk_2": rec["sk_2"],
           "seg_id": pred["seg_id"]}
    for i in range(len(points)):
        print(f"shape {i}: seg_iou {out['seg_iou'][i]:.4f} residual "
              f"{out['residual'][i]:.4f} sk1 {out['sk_1'][i]:.3f}",
              flush=True)
    return out


def parity_table(agg: dict, expected: dict, tolerance: float = 0.01,
                 knn: str = "exact", source: str = "") -> dict:
    """Print the table of the column means against `expected` and the
    validate floors; returns the JSON summary."""
    meta = expected.get("_meta", {})
    print(f"\n=== parity vs {meta.get('source', source)} "
          f"(tolerance {tolerance:.0%}; higher_is_better per column) ===")
    print(f"{'metric':<10} {'measured':>10} {'expected':>10} {'ratio':>8}  "
          "verdict")
    rows = []
    for k in COLUMNS:
        got = float(np.mean(agg[k]))
        exp = expected.get(k)
        if exp is None:
            print(f"{k:<10} {got:>10.4f} {'-':>10}        -  (no target)")
            rows.append({"metric": k, "measured": got})
            continue
        ratio = got / exp if exp else float("inf")
        ok = (ratio <= 1 + tolerance if k in LOWER_IS_BETTER
              else ratio >= 1 - tolerance)
        print(f"{k:<10} {got:>10.4f} {exp:>10.4f} {ratio:>8.3f}  "
              f"{'PASS' if ok else 'FAIL'}")
        rows.append({"metric": k, "measured": got, "expected": exp,
                     "pass": bool(ok)})
    with open(FLOORS) as f:
        floors = json.load(f)["validate"]
    fl_ok = (float(np.mean(agg["seg_iou"])) >= floors["seg_iou_min"]
             and float(np.mean(agg["residual"])) <= floors["residual_max"]
             and float(np.mean(agg["sk_2"])) >= floors["sk_2_min"])
    print(f"floors ({'PASS' if fl_ok else 'FAIL'}): "
          f"seg_iou>={floors['seg_iou_min']} "
          f"residual<={floors['residual_max']} sk_2>={floors['sk_2_min']}")
    summary = {"n_shapes": len(agg["seg_iou"]), "rows": rows, "knn": knn,
               "floors_ok": bool(fl_ok), "floors_protocol": "validate"}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Two-stage evaluation of a test split with a parity "
                    "table.")
    ap.add_argument("config", nargs="?",
                    default="configs/config_eval_final.yml")
    ap.add_argument("--num-shapes", type=int, default=0,
                    help="cap on test shapes (0 = config.num_test)")
    ap.add_argument("--expected", default=EXPECTED)
    ap.add_argument("--no-preprocess", action="store_true",
                    help="no eval-mode outlier removal and upsampling")
    ap.add_argument("--tolerance", type=float, default=0.01)
    ap.add_argument("--knn-recall", default="exact",
                    help="'exact', the port's only kNN")
    ap.add_argument("--params", default=os.environ.get("BENCH_PARAMS", ""),
                    help="explicit npz export to evaluate (as cli.bench's "
                         "BENCH_PARAMS, which is also read)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.knn_recall != "exact":
        ap.error("--knn-recall: the port builds exact kNN graphs only")
    dev = entry_device(args.device)
    cfg = load_config(args.config)
    model, src = load_weights(cfg, args.params, dev)
    print(f"validate: evaluating params from {src}", flush=True)
    spline_fit = trained_spline_fit(cfg.log_dir, cfg.grid_size, dev)
    points, labels, normals, prim = load_test_split(cfg)
    n = min(args.num_shapes or cfg.num_test or len(points), len(points))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    agg = validate_split(model, points[:n], normals[:n], labels[:n],
                         prim[:n], spline_fit, generator=gen,
                         eval_preprocess=not args.no_preprocess, device=dev)
    with open(args.expected) as f:
        expected = json.load(f)
    return parity_table(agg, expected, args.tolerance, args.knn_recall,
                        args.expected)


if __name__ == "__main__":
    main()
