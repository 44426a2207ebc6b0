"""Evaluate the open-spline SplineNet (the port's counterpart of the root
test_open_splines.py).

    python -m parsenet_tpu_torch.cli.test_open_splines \\
        configs/config_open_splines.yml [--optimize] [--export DIR] \\
        [--device cuda]

Reads the decoder the port's trainer saves, {log_dir}/checkpoints/
{model_path}.npz, and the config's test split, and logs the mean two-sided
sqrt chamfer (and, with --optimize, the chamfer after the classical refit;
--export writes gt / pred meshes as PLY): eval.splines.evaluate_splinenet.
"""
from __future__ import annotations

import argparse

from ..core.config import load_config
from ..core.logging import setup_logging
from ..eval.splines import evaluate_splinenet


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Evaluate the open-spline SplineNet.")
    ap.add_argument("config", help="configs/config_open_splines.yml")
    ap.add_argument("--optimize", action="store_true",
                    help="also refit each surface and report cd_optim")
    ap.add_argument("--export", default=None, metavar="DIR",
                    help="write gt / pred meshes as PLY into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    setup_logging(cfg.log_dir, "test_open_splines")
    return evaluate_splinenet(cfg, closed=False, if_optimize=args.optimize,
                              export_dir=args.export, device=args.device)


if __name__ == "__main__":
    main()
