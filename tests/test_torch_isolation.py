"""The port stands alone: parsenet_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, and the entry points run on the card by
default and refuse to fall back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "parsenet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "parsenet_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import parsenet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
        "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120, check=True)
    n_modules, loaded = out.stdout.splitlines()
    assert int(n_modules) >= 15
    bad = [m for m in loaded.split() if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("sub", ["cli", "cpp", "postprocess"])
def test_host_side_and_entry_points_load_no_jax(sub):
    """Every module of cli/, cpp/ and postprocess/, imported alone, loads
    neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import parsenet_tpu_torch.{sub} as p\n"
        "names = [p.__name__] + [m.name for m in pkgutil.walk_packages("
        "p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
        "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120, check=True)
    n_modules, loaded = out.stdout.splitlines()
    assert int(n_modules) >= (9 if sub == "cli" else 1)
    bad = [m for m in loaded.split() if _forbidden(m)]
    assert not bad, bad


def test_native_build_reads_no_path_of_the_jax_package():
    """The native library is compiled from the port's own copies of the C++
    sources, into parsenet_tpu_torch/csrc/build/."""
    from parsenet_tpu_torch import cpp
    jax_pkg = str(REPO / "parsenet_tpu") + os.sep
    cmd = cpp.build_command(cpp.lib_path())
    paths = [a for a in cmd if os.sep in a]
    assert len(paths) == 1 + len(cpp.SOURCES), cmd
    for a in paths:
        assert a.startswith(str(PKG) + os.sep) and not a.startswith(jax_pkg)
    assert str(cpp.lib_path()).startswith(str(PKG / "csrc" / "build"))
    assert all(s.parent == PKG / "cpp" for s in cpp.SOURCES)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"),
                                        REPO / "chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_refuse_cpu_fallback(tmp_path, monkeypatch):
    # the JAX package's bench.py sets PARSENET_KNN_RECALL when a test
    # imports it, and the port's bench refuses that knob before the device
    monkeypatch.delenv("PARSENET_KNN_RECALL", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib
    from parsenet_tpu_torch.eval import pipeline as tp
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    z3 = np.zeros((1, 32, 3), np.float32)
    z1 = np.zeros((1, 32), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_primitives_embedding(str(REPO / "params" / "parsenet_e2e.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.predict_segmentation(lambda x: None, z3, z3, z1, z1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.reconstruct_shape(z3[0], z3[0], z1[0], z1[0],
                             uniforms=torch.zeros(tp.COV_SAMPLES))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.run_batch(lambda x: None, z3, z3, z1, z1, torch.Generator())
    # the CLIs, before they read a file: the config names none that exist
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(f'[train]\ndataset = "{tmp_path}/absent/"\n'
                   f'log_dir = "{tmp_path}/logs"\n')
    for name in ("generate_predictions", "test", "test_open_splines",
                 "test_closed_control_points", "train_parsenet",
                 "train_parsenet_e2e", "train_open_splines",
                 "train_closed_control_points"):
        cli = importlib.import_module(f"parsenet_tpu_torch.cli.{name}")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([str(cfg)])
    # the benches, before they build anything
    from parsenet_tpu_torch.cli import bench, bench_train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    for which in ("seg", "e2e"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_train.main([which])
    from parsenet_tpu_torch.eval.metrics import iou_from_embeddings
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iou_from_embeddings(np.eye(4, dtype=np.float32), np.arange(4))


def test_kernel_wrappers_take_no_other_device():
    """A wrapper runs its plain version only for CPU tensors; anything else
    it cannot launch on raises instead of falling back."""
    from parsenet_tpu_torch.ops import kernels
    x = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.min_sqdist_with_idx(x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.mean_shift_iterations(torch.empty((8, 16), device="meta"),
                                      0.5, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.auction_assign(torch.empty((8, 8), device="meta"), 1e-5,
                               150, 8.0, 10)
    m = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.mean_shift_step(m, m, 2.0)
    q = torch.empty((2, 8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.min_sqdist_bwd(q, q, torch.empty((2, 8), device="meta",
                                                 dtype=torch.int32),
                               torch.empty((2, 8), device="meta"))


def test_kernel_sources_target_sm90a():
    from parsenet_tpu_torch.ops import kernels
    assert "arch=compute_90a,code=sm_90a" in " ".join(kernels.NVCC_FLAGS)
    for name, src in kernels.SOURCES.items():
        text = (kernels.CSRC / src).read_text()
        assert "Replaces: parsenet_tpu/ops/pallas_kernels.py" in text, src
        assert "Bound on this card" in text and "Design" in text, src
        assert 'extern "C"' in text and "cudaGetLastError" in text, src
