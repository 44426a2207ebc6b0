"""Train the open-spline SplineNet (the port's counterpart of the root
train_open_splines.py): train.train_spline.main.

    python -m parsenet_tpu_torch.cli.train_open_splines \
        configs/config_open_splines.yml [--device cuda]
"""
from ..train import train_spline


def main(argv=None) -> None:
    train_spline.main(argv)


if __name__ == "__main__":
    main()
