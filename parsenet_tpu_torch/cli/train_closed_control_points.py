"""Train the closed-spline SplineNet (the port's counterpart of the root
train_closed_control_points.py): train.train_spline.main.

    python -m parsenet_tpu_torch.cli.train_closed_control_points \
        configs/config_closed_splines.yml [--device cuda]
"""
import sys

from ..train import train_spline


def main(argv=None) -> None:
    train_spline.main([*(sys.argv[1:] if argv is None else argv), "--closed"])


if __name__ == "__main__":
    main()
