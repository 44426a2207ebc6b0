"""Continue the e2e fine-tune from the SHIPPED weights, selecting the best
epoch at the scale the shipping gate measures (the port's counterpart of
scripts/finetune_e2e.py).

configs/config_parsenet_e2e.yml at full width (DGCNN mode 5, k 80,
embedding 128, 8,000 training points, batch 1, accumulation 5) from
params/parsenet_e2e.npz with the decoders train.train_e2e takes
({log_dir}/checkpoints/{open,closed}_splinenet.npz where both exist, else
the shipped params/), at a reduced lr (5e-5: a continuation of a converged
model). Each epoch is scored on a FIXED sample of --val-shapes shapes at
--val-points points: selection at a reduced point count does not carry
over to the 10k bench protocol, so the sample is drawn at 10,000 while
training draws 8,000. --fast-step trains with train_e2e.FAST_STEP_KNOBS.

The checkpoint goes to {log_dir}/checkpoints/{--model-path}.npz,
parsenet_e2e_ft by default: a name cli.bench never restores, so a half
finished run cannot reach a bench. The route to shipped weights:

    python -m parsenet_tpu_torch.cli.finetune_e2e --epochs 6
    python -m parsenet_tpu_torch.cli.export_params \\
        --e2e-ckpt parsenet_e2e_ft --e2e-out logs/cand_e2e.npz
    BENCH_PARAMS=logs/cand_e2e.npz python -m parsenet_tpu_torch.cli.bench \\
        > logs/cand_a.json
    BENCH_PARAMS=logs/cand_e2e.npz BENCH_STREAM=b \\
        python -m parsenet_tpu_torch.cli.bench > logs/cand_b.json
    BENCH_STREAM=b python -m parsenet_tpu_torch.cli.bench > logs/shipped_b.json
    python -m parsenet_tpu_torch.cli.bench > logs/shipped_a.json
    python -m parsenet_tpu_torch.cli.promote_candidate \\
        --cand logs/cand_e2e.npz --gate-a logs/cand_a.json \\
        --gate-b logs/cand_b.json --shipped-b logs/shipped_b.json \\
        --shipped-a-json logs/shipped_a.json

Only the last step writes params/, and only when the gate is green.

    python -m parsenet_tpu_torch.cli.finetune_e2e [--epochs 6] [--lr 5e-5] \\
        [--val-points 10000] [--val-shapes 24] [--fast-step] \\
        [--model-path parsenet_e2e_ft] [--device cuda]

It reads the config's h5 splits ({dataset}{train,val}_data.h5) and fails
without them; `finetune` takes generators instead.
"""
import argparse
import os

from ..core.checkpoint import load_npz_params
from ..core.config import Config, load_config
from ..core.guards import entry_device
from ..core.logging import setup_logging, snapshot_config
from ..train.state import TrainResult
from ..train.train_e2e import run_training

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "config_parsenet_e2e.yml")
SHIPPED = os.path.join(REPO, "params", "parsenet_e2e.npz")


def finetune_config(epochs: int = 6, lr: float = 5e-5,
                    model_path: str = "parsenet_e2e_ft",
                    fast_step: bool = False, **overrides) -> Config:
    """configs/config_parsenet_e2e.yml with the fine-tune's settings (the
    split sizes of scripts/finetune_e2e.py; no pretrained segmentation
    checkpoint: the shipped weights are the start)."""
    kw = dict(num_train=180, num_val=160, num_test=160, num_epochs=epochs,
              lr=lr, model_path=model_path, fast_step=fast_step,
              pretrain_model_path="")
    kw.update(overrides)
    return load_config(CONFIG, **kw)


def finetune(cfg: Config, val_shapes: int = 24, val_points: int = 10000,
             device=None, **kw) -> TrainResult:
    """train_e2e.run_training from the shipped weights with the fine-tune's
    fixed validation sample; kw are run_training's (generators,
    steps_per_epoch, spline_fit, checkpoint, timer). SystemExit without the
    shipped export."""
    if not os.path.exists(SHIPPED):
        raise SystemExit(f"{SHIPPED} missing: nothing to continue from")
    return run_training(cfg, pretrained=load_npz_params(SHIPPED),
                        val_shapes=val_shapes, val_points=val_points,
                        device=device, **kw)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(
        description="Continue the e2e fine-tune from the shipped weights.")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--lr", type=float, default=5e-5,
                    help="half the from-scratch e2e lr: a continuation of "
                         "a converged checkpoint")
    ap.add_argument("--val-points", type=int, default=10000)
    ap.add_argument("--val-shapes", type=int, default=24)
    ap.add_argument("--fast-step", action="store_true",
                    help="train with the Config.fast_step bundle "
                         "(train_e2e.FAST_STEP_KNOBS); its weights must "
                         "still pass the gate")
    ap.add_argument("--model-path", default="parsenet_e2e_ft",
                    help="checkpoint name under {log_dir}/checkpoints/ "
                         "(never one cli.bench restores)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    cfg = finetune_config(args.epochs, args.lr, args.model_path,
                          args.fast_step)
    setup_logging(cfg.log_dir, args.model_path)
    snapshot_config(cfg, cfg.log_dir, args.model_path)
    return finetune(cfg, args.val_shapes, args.val_points, device=dev)


if __name__ == "__main__":
    main()
