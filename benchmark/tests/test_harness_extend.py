"""A later change adds a configuration, a cell and a per-layer metric as
new files and new BENCHMARK.json entries, and edits no file that is
there: shown in a temporary copy of the benchmark, whose new cell runs on
the CPU at a tiny size."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

RUN = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(1)
from benchmark import harness
from benchmark.session import run_cell, per_layer
from benchmark.trace import Reading
import parsenet_tpu_torch.eval.pipeline as program
from benchmark.reference.plain.eval import pipeline as reference
program.EVAL_SPLINE_SLOTS = reference.EVAL_SPLINE_SLOTS = 1
cell = harness.Cell(harness.load_spec(), "e2e-segment-5k")
assert harness.BENCH == harness.ROOT / "benchmark"
res = run_cell(cell, torch.device("cpu"), 2 ** 31 + 31, 1.0)["result"]
reading = Reading("infer", {"dgcnn": 6.0, "mean_shift": 9.0}, 4, 2, 1.0,
                  {"flops_per_shape": 1.0}, None)
print(json.dumps({"result": res, "layer": per_layer(cell, reading),
                  "network": cell.config["network"]["k"]}))
'''


def test_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    for name in ("parsenet_tpu_torch", "params"):
        os.symlink(harness.ROOT / name, root / name)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"

    cfg = json.loads((b / "configs" / "parsenet_e2e.json").read_text())
    cfg["name"] = "parsenet_e2e_k16"
    cfg["network"]["k"] = 16
    cfg["reduced"] = ["k"]
    (b / "configs" / "parsenet_e2e_k16.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "mixes" / "segment-10k-b4.json").read_text())
    mix.update(points=300, batch=2, pool_shapes=4, check_span=1,
               check_requests=1)
    (b / "mixes" / "segment-300-b2.json").write_text(json.dumps(mix))
    cell = json.loads((b / "workloads" / "e2e-segment.json").read_text())
    cell["config"], cell["traffic"] = "parsenet_e2e_k16", "segment-300-b2"
    (b / "workloads" / "e2e-segment-5k.json").write_text(json.dumps(cell))
    (b / "metrics" / "clustering_share.infer.py").write_text(
        '"""Clustering\'s share of the stages, %."""\n\n\n'
        "def read(r):\n"
        "    ms = r.per_unit('mean_shift')\n"
        "    total = r.per_unit(*r.stage_ms)\n"
        "    return None if ms is None else 100.0 * ms / total\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "parsenet_e2e_k16",
                            "source": "https://arxiv.org/abs/2003.12181",
                            "file": "benchmark/configs/parsenet_e2e_k16.json",
                            "reduced": ["k"], "why": "a test's config"})
    spec["workloads"].append({"name": "e2e-segment-5k",
                              "config": "parsenet_e2e_k16",
                              "traffic": "segment-300-b2", "chips": 1,
                              "why": "a test's cell"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "e2e-segment" in m["workloads"]:
            m["workloads"].append("e2e-segment-5k")
    spec["per_layer"].append({"name": "clustering_share.infer", "unit": "%",
                              "better": "lower", "source": "program_span",
                              "layer": "clustering",
                              "moves": "shapes_per_s",
                              "workloads": ["e2e-segment-5k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    out = subprocess.run([sys.executable, "-c", RUN, str(root)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["result"]["correct"], got["result"]["check"]
    assert got["network"] == 16
    assert set(got["result"]["metrics"]) == {"shapes_per_s", "batch_ms_p90",
                                             "setup_s"}
    assert got["layer"]["clustering_share.infer"]["value"] == 60.0
    after = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == v for p, v in before.items())
