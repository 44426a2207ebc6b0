"""Train ParSeNet end to end with the fitting loss (the port's counterpart
of the root train_parsenet_e2e.py): train.train_e2e.main.

    python -m parsenet_tpu_torch.cli.train_parsenet_e2e \
        configs/config_parsenet_e2e.yml [--device cuda]
"""
from ..train import train_e2e


def main(argv=None) -> None:
    train_e2e.main(argv)


if __name__ == "__main__":
    main()
