"""Time the port's training loops of one checkout on the card.

    python3 scripts/torch_train_loop_times.py --root DIR [--no-lookahead]

Runs, from DIR's parsenet_tpu_torch, train_spline.run_training open (3
warm-up + 20 timed steps) and closed (1 + 10), 36 synthetic patches of 700
points (data.splines.synthetic_batches, chip_smoke.py phase 5's data), and
train_e2e.run_training on configs/config_parsenet_e2e.yml at full width
(1 + 3 steps of 5 shapes of 8,000 points, the shipped weights and
decoders), and prints one JSON line: ms a step from CUDA events, from the
first timed step's first stage to the last step's end, and the stages.
--no-lookahead replaces the trainers' data.prefetch.lookahead with the
bare generator (a tree that has it). To compare two trees, unpack the
parent with `git archive` into a git-ignored directory and run both in one
chip call, in turns: parent, change, change, parent.
"""
import argparse
import contextlib
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--no-lookahead", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from parsenet_tpu_torch.core.checkpoint import load_npz_params
    from parsenet_tpu_torch.core.config import Config, load_config
    from parsenet_tpu_torch.core.profiling import StageTimer
    from parsenet_tpu_torch.data.splines import synthetic_batches
    from parsenet_tpu_torch.data.synthetic import make_shape_batch
    from parsenet_tpu_torch.fitting.spline_apply import build_spline_fit
    from parsenet_tpu_torch.train import train_e2e, train_spline

    if args.no_lookahead:
        train_spline.lookahead = train_e2e.lookahead = lambda it, size=2: it
    dev = torch.device("cuda")
    log_dir = os.path.join(root, "chiprun_out", "train_loop_times")
    out = {"root": args.root, "lookahead": not args.no_lookahead,
           "card": torch.cuda.get_device_name(0)}

    class AfterWarmup(StageTimer):
        def __init__(self, warm):
            super().__init__(True)
            self.warm, self.seen = warm, 0

        def __call__(self, stage):
            if self.seen >= self.warm:
                return super().__call__(stage)
            if stage == "optimizer":
                self.seen += 1
            return contextlib.nullcontext()

    def ms_per_step(timer, timed):
        timer.ms()
        ev = timer.events
        return (next(iter(ev.values()))[0][0].elapsed_time(
            ev["optimizer"][-1][1]) / timed,
            {k: sum(a.elapsed_time(b) for a, b in v) / timed
             for k, v in ev.items()})

    for name, warm, timed in (("open", 3, 20), ("closed", 1, 10)):
        closed = name == "closed"
        gen = synthetic_batches(np.random.RandomState(10 + closed), 36, 700,
                                20, closed)
        batches = [next(gen) for _ in range(warm + timed + 2)]
        cfg = Config(model_path="loop_times", batch_size=36, grid_size=20,
                     lr=1e-3, loss_weight=0.9, num_epochs=1, seed=0,
                     log_dir=log_dir)
        timer = AfterWarmup(warm)
        train_spline.run_training(cfg, closed, iter(batches[:-2]),
                                  iter(batches[-2:]), warm + timed,
                                  val_steps=2, checkpoint=False, device=dev,
                                  timer=timer)
        out[name], out[f"{name}_stages"] = ms_per_step(timer, timed)

    conf = load_config(os.path.join(root, "configs",
                                     "config_parsenet_e2e.yml")).replace(
        num_epochs=1, model_path="loop_times_e2e", log_dir=log_dir)
    per = conf.batch_size * conf.accum
    tr = make_shape_batch(np.random.RandomState(20), 4 * per, 10000)
    va = make_shape_batch(np.random.RandomState(21), 2, 10000)
    timer = AfterWarmup(1)
    train_e2e.run_training(
        conf, (tuple(a[i:i + per] for a in tr) for i in range(0, 4 * per,
                                                              per)),
        (tuple(a[i:i + 1] for a in va) for i in range(2)), steps_per_epoch=4,
        points_per_shape=conf.num_points,
        pretrained=load_npz_params(os.path.join(root, "params",
                                                "parsenet_e2e.npz")),
        spline_fit=build_spline_fit(device=dev), val_shapes=2,
        checkpoint=False, device=dev, timer=timer)
    out["e2e"], out["e2e_stages"] = ms_per_step(timer, 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
