"""The whole training workflow, data to e2e checkpoint (the port's
counterpart of scripts/train_workflow.py).

Stages, each in its own subprocess so that one failing does not take the
others' state with it:
  data    synthetic h5 datasets (cli.make_synthetic_data: 960 shapes,
          512 spline patches), skipped where data/shapes/train_data.h5
          exists;
  open    the open SplineNet (cli.train_open_splines), 20 epochs;
  closed  the closed SplineNet (cli.train_closed_control_points), 20 epochs;
  seg     the segmentation network (cli.train_parsenet, mode 5), 40
          epochs, batch 1 with 6 accumulated micro-batches (the same
          6-shape averaged gradient as batch 2 x 3);
  e2e     the e2e fine-tune (cli.train_parsenet_e2e), 10 epochs.
Each trainer reads a config derived from configs/ (the split sizes and
epochs above) written to {log_dir}/workflow/<stage>.yml. The checkpoints
land under logs/checkpoints/ ({open,closed}_splinenet,
parsenet_seg_normals, parsenet_e2e; npz). Then cli.export_params and the
gate (cli.promote_candidate) decide what reaches params/.

    python -m parsenet_tpu_torch.cli.train_workflow [stage ...] \\
        [--device cuda]

Default: every stage, in order. WORKFLOW_BF16=1 trains seg and e2e with
half_precision (the bf16 network, f32 weights and statistics).
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

from ..core.config import Config, load_config
from ..core.guards import entry_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = ("data", "open", "closed", "seg", "e2e")
# stage -> (config under configs/, its overrides, the trainer's CLI)
TRAINERS = {
    "open": ("config_open_splines.yml",
             dict(num_train=440, num_val=36, num_test=36, num_epochs=20),
             "train_open_splines"),
    "closed": ("config_closed_splines.yml",
               dict(num_train=440, num_val=36, num_test=36, num_epochs=20),
               "train_closed_control_points"),
    "seg": ("config_parsenet_normals.yml",
            dict(num_train=960, num_val=160, num_test=160, num_epochs=40,
                 batch_size=1, accum=6), "train_parsenet"),
    "e2e": ("config_parsenet_e2e.yml",
            dict(num_train=180, num_val=160, num_test=160, num_epochs=10),
            "train_parsenet_e2e"),
}


def write_ini(cfg: Config, path: str) -> str:
    """`cfg` in the configs/*.yml dialect that core.config parses."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lines = ["[train]"]
    for k, v in dataclasses.asdict(cfg).items():
        lines.append(f'{k} = "{v}"' if isinstance(v, str) else f"{k} = {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def stage_config(name: str, bf16: bool = False) -> Config:
    """The derived config of a trainer stage."""
    base, overrides, _ = TRAINERS[name]
    kw = dict(overrides)
    if bf16 and name in ("seg", "e2e"):
        kw["half_precision"] = True
    return load_config(os.path.join(REPO, "configs", base), **kw)


def stage_command(name: str, device=None, bf16: bool = False) -> list:
    """The argv of a stage's subprocess (a trainer's derived config is
    written on the way)."""
    if name == "data":
        return [sys.executable, "-m",
                "parsenet_tpu_torch.cli.make_synthetic_data", "--shapes",
                "960", "--splines", "512"]
    cfg = stage_config(name, bf16)
    path = write_ini(cfg, os.path.join(cfg.log_dir, "workflow",
                                       f"{name}.yml"))
    cmd = [sys.executable, "-m", f"parsenet_tpu_torch.cli.{TRAINERS[name][2]}",
           path]
    return cmd + (["--device", device] if device else [])


def run_stage(name: str, device=None) -> None:
    t0 = time.time()
    print(f"=== stage {name} start", flush=True)
    if name == "data" and os.path.exists("data/shapes/train_data.h5"):
        print("=== stage data skipped (data/ exists)", flush=True)
        return
    subprocess.check_call(stage_command(
        name, device, os.environ.get("WORKFLOW_BF16") == "1"))
    print(f"=== stage {name} done in {time.time() - t0:.0f}s", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Run the training workflow's stages in order.")
    ap.add_argument("stages", nargs="*", help=f"any of {STAGES} (all)")
    ap.add_argument("--device", default=None,
                    help="torch device of the trainers (default cuda)")
    args = ap.parse_args(argv)
    wanted = args.stages or list(STAGES)
    for s in wanted:
        if s not in STAGES:
            raise SystemExit(f"unknown stage {s}; choose from {STAGES}")
    if set(wanted) - {"data"}:
        entry_device(args.device)     # the trainers' card, before any stage
    for s in wanted:
        run_stage(s, args.device)
    print("=== workflow complete", flush=True)


if __name__ == "__main__":
    main()
