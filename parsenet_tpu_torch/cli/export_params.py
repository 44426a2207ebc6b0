"""Export the port's trained checkpoints to compact npz files (the port's
counterpart of scripts/export_params.py).

The trainers save flat f32 npz checkpoints under {log_dir}/checkpoints/
(core.checkpoint.save_npz_params / save_train_state). An export keeps the
same keys and writes every params/... array as float16 and every
batch_stats/... array (SplineNet's running statistics, which can be tiny)
as float32, in one np.savez_compressed: the layout of the committed
params/*.npz, which cli.bench and every loader of the port read.

    python -m parsenet_tpu_torch.cli.export_params [--log-dir logs] \\
        [--e2e-ckpt NAME --e2e-out PATH] [--spline-out-prefix params/]

--e2e-ckpt exports only {log_dir}/checkpoints/NAME.npz to --e2e-out
(exit 1 when it is missing); write it to a candidate path so that params/
is written only by a green gate (cli.promote_candidate). Without it the
segmentation network (parsenet_e2e, else parsenet_seg_normals) and both
SplineNets are exported, each one whose checkpoint exists.
"""
import argparse
import os

import numpy as np

from ..core.checkpoint import load_npz_params


def half_precision_export(flat: dict) -> dict:
    """The export rule: params/... arrays to float16, the rest (batch
    statistics) float32."""
    return {k: (np.asarray(v).astype(np.float16) if k.startswith("params")
                else np.asarray(v, np.float32)) for k, v in flat.items()}


def export(ckpt_path: str, out_path: str) -> bool:
    """Write the export of the npz checkpoint at ckpt_path to out_path;
    False (and a line saying so) when there is no checkpoint."""
    if not os.path.exists(ckpt_path):
        print(f"skip {ckpt_path}: no checkpoint")
        return False
    half = half_precision_export(load_npz_params(ckpt_path))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **half)
    mb = os.path.getsize(out_path) / 1e6
    print(f"wrote {out_path} ({mb:.1f} MB, {len(half)} arrays, from "
          f"{ckpt_path})")
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Export trained npz checkpoints to f16 npz files.")
    ap.add_argument("--e2e-ckpt", default="",
                    help="checkpoint name under {log_dir}/checkpoints/ to "
                         "export as the segmentation network (e.g. "
                         "parsenet_e2e_ft, the fine-tune's); exports only "
                         "that one")
    ap.add_argument("--e2e-out", default="params/parsenet_e2e.npz",
                    help="output npz (with --e2e-ckpt use a candidate path "
                         "outside params/ until the gate passes)")
    ap.add_argument("--log-dir", default="logs",
                    help="training log directory holding checkpoints/")
    ap.add_argument("--spline-out-prefix", default="params/",
                    help="prefix of the {open,closed}_splinenet.npz exports")
    args = ap.parse_args(argv)

    ck = os.path.join(args.log_dir, "checkpoints")
    if args.e2e_ckpt:
        if not export(os.path.join(ck, f"{args.e2e_ckpt}.npz"),
                      args.e2e_out):
            raise SystemExit(1)
        return
    export(os.path.join(ck, "parsenet_e2e.npz"), args.e2e_out) \
        or export(os.path.join(ck, "parsenet_seg_normals.npz"), args.e2e_out)
    for name in ("open_splinenet", "closed_splinenet"):
        export(os.path.join(ck, f"{name}.npz"),
               f"{args.spline_out_prefix}{name}.npz")


if __name__ == "__main__":
    main()
