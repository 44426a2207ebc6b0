#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (timed as setup_s) loads the program
and its weights, builds its kernels into the checkout, makes the cell's
shape pool and every other input from --seed, and runs the first requests
or steps. The window then runs requests for --seconds, one client in a
closed loop. With --trace 1 the program's stages are timed by CUDA events
and a short stretch of the window runs under torch.profiler; the result
holds the cell's per-layer metrics instead of its end-to-end ones. After
the window the program is freed and the plain reference (benchmark/
reference/) answers the same inputs; `correct` holds where every compared
number is within its limit (benchmark/workloads/<cell>.json). The last
line of standard output is one JSON object; the numbers compared, each
with its limit, are the last lines of standard error.

Exits 2 without a result where CUDA is missing or has fewer cards than the
cell asks for, and 3 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402
from benchmark.harness import say  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(harness.load_spec(), args.workload)
    harness.use_checkout_caches()
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        say(f"needs {cell.chips} CUDA card(s), found {cards}")
        return 2
    from benchmark.session import run_cell

    dev = torch.device("cuda", 0)
    say(f"cell {cell.name} seed {args.seed} card {harness.card_line()}")
    out = run_cell(cell, dev, args.seed, args.seconds, bool(args.trace))
    result = out["result"]
    result["device"]["kind"] = torch.cuda.get_device_name(dev)
    if args.trace:
        say(f"stages ms {json.dumps(out['stage_ms'])}")

    found = harness.forbidden_modules()
    if found:
        say(f"forbidden modules loaded: {found}")
        return 3
    for k, c in result["check"].items():
        say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
