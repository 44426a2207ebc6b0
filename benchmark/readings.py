#!/usr/bin/env python3
"""The readings the check's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--seconds 4]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (inference) or the first checked steps (training), and
the compared numbers of the program against the reference (the lower
readings), of the control (the reference one step lower in precision,
put in the program's place: benchmark.reference.precision) against the
reference and, as upper readings too, of the planted faults: in training
cells the reference leaving out half of each step's batch, in inference
cells the program with a fault after the network in half of each
request's shapes (benchmark/faults.py). One JSON line a seed;
nothing here is run by benchmark/run.py.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402


def _window(drv, seed: int, seconds: float, cuda: bool) -> dict:
    """Set-up and a short window at the cell's own load, run on until
    every sampled request is done (inference), or the checked steps
    (training) -> the program's outputs."""
    from benchmark.loops import closed_loop
    drv.start(harness.seeds(seed))
    drv.warm()
    if drv.kind == "infer":
        start = drv.next_index
        while start <= max(drv.sample):
            start = closed_loop(drv.enqueue, drv.fetch, drv.units_of,
                                seconds, start, cuda=cuda).next_index
            seconds = 1.0
    return drv.program_outputs()


def readings(cell, dev, seed: int, seconds: float, drv=None) -> dict:
    """One seed's readings; `drv` is the cell's driver, made once."""
    from benchmark import faults
    cuda = dev.type == "cuda"
    if drv is None:
        drv = harness.load_module("drivers", cell.driver).Driver(cell, dev)
    prog = _window(drv, seed, seconds, cuda)
    ref = drv.reference_outputs(prog)
    out = {"seed": seed, "program": drv.compare(prog, ref),
           "control": drv.compare(drv.reference_outputs(prog, low=True),
                                  ref)}
    if drv.kind == "train":
        out["half_batch"] = drv.compare(
            drv.reference_outputs(prog, half=True), ref)
    for fault in faults.AFTER_NETWORK.get(cell.driver, ()):
        with fault(int(cell.mix["batch"])):
            out[fault.__name__] = drv.compare(
                _window(drv, seed, seconds, cuda), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_spec(), args.workload)
    harness.use_checkout_caches()
    import torch
    if not torch.cuda.is_available():
        harness.say("readings need a CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    drv = harness.load_module("drivers", cell.driver).Driver(cell, dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, dev, seed, args.seconds, drv)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
