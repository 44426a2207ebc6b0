"""Train the ParSeNet segmentation network (the port's counterpart of
the root train_parsenet.py): train.train_seg.main.

    python -m parsenet_tpu_torch.cli.train_parsenet \
        configs/config_parsenet.yml [--device cuda]
"""
from ..train import train_seg


def main(argv=None) -> None:
    train_seg.main(argv)


if __name__ == "__main__":
    main()
