"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names; the reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REFERENCE = harness.BENCH / "reference"
PROGRAM = ("parsenet_tpu_torch",)


def _imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_whole_top_level_names(monkeypatch):
    fake = {"parsenet_tpu_torch.ops": None, "jaxlib.xla": None,
            "parsenet_tpu.core": None, "jax_like": None, "flaxen": None}
    for name in fake:
        monkeypatch.setitem(sys.modules, name, object())
    found = harness.forbidden_modules()
    assert "jaxlib.xla" in found and "parsenet_tpu.core" in found
    assert not {"parsenet_tpu_torch.ops", "jax_like", "flaxen"} & set(found)


def test_reference_sources_import_nothing_of_the_program():
    files = sorted(REFERENCE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = _imported_tops(f) & set(harness.FORBIDDEN + PROGRAM)
        assert not bad, (f, bad)


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.infer, benchmark.reference.train, "
            "benchmark.reference.compare\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('parsenet_tpu_torch', 'parsenet_tpu', 'jax', 'jaxlib', "
            "'flax'))\n"
            "print(bad); sys.exit(1 if bad else 0)" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_a_cell_loads_no_jax(name):
    """Set-up of the cell's driver on the CPU (the program, its weights,
    the reference) in a fresh process, then the isolation check run.py
    makes once the window has closed."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from benchmark import harness\n"
            "from benchmark.tests.tiny import tiny_cell\n"
            "cell = tiny_cell(%r)\n"
            "drv = harness.load_module('drivers', cell.driver).Driver("
            "cell, torch.device('cpu'))\n"
            "import benchmark.reference.infer, benchmark.reference.train\n"
            "bad = harness.forbidden_modules()\n"
            "print(bad); sys.exit(1 if bad else 0)"
            % (str(harness.ROOT), name))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**__import__("os").environ,
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_refuses_without_a_card_or_program(tmp_path):
    """run.py on a machine without CUDA exits 2 and prints no result; in a
    directory holding only BENCHMARK.json and the benchmark it fails."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "e2e-protocol",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "e2e-protocol",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
