"""What every cell shares: finding its files by name, the seeds, the card,
the isolation check and the result line.

Nothing here imports the program; the drivers do, in set-up.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType

import numpy as np

ROOT = Path(__file__).resolve().parent.parent   # the checkout
BENCH = ROOT / "benchmark"
# top-level module names that may not be loaded in a run's process: JAX,
# its libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "parsenet_tpu")
# fixed cache directories inside the checkout (git-ignored)
CACHE = ROOT / ".bench_cache"


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json: kind is configs, mixes or workloads."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """benchmark/<kind>/<name>.py loaded by its path (a metric's name holds
    a dot, so it is no importable module name)."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's workloads with its files: the cell's
    own (workloads/<name>.json), its configuration's and its mix's."""

    def __init__(self, spec: dict, name: str):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise SystemExit(f"benchmark: no workload {name!r} in "
                             f"BENCHMARK.json ({sorted(entries)})")
        self.entry = entries[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.spec = load_json("workloads", name)
        self.config = load_json("configs", self.entry["config"])
        self.mix = load_json("mixes", self.entry["traffic"])
        self.driver = self.spec["driver"]
        self.limits = self.spec["limits"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def seeds(seed: int) -> dict:
    """The run's seeds, all derived from --seed (any whole number): the
    shape pool's RandomState, the torch generators' base, the network's
    initialisation, the point subsample's RandomState, the check's sample."""
    words = np.random.SeedSequence(abs(int(seed)) + (int(seed) < 0)
                                   ).generate_state(6, dtype=np.uint32)
    w = [int(x) for x in words]
    return {"pool": w[0], "torch": (w[1] << 31) | (w[2] >> 1),
            "init": w[3], "subsample": w[4], "sample": w[5]}


def use_checkout_caches() -> None:
    """Every build and kernel cache in fixed directories of the checkout;
    JAX kept out of libraries that would load it by themselves."""
    CACHE.mkdir(exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: parsenet_tpu_torch is not parsenet_tpu."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def say(*parts) -> None:
    print("benchmark:", *parts, file=sys.stderr, flush=True)
