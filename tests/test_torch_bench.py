"""The port's bench entry point (parsenet_tpu_torch.cli.bench) on the CPU,
as tests/test_bench_params.py and tests/test_bench_watchdog.py hold
bench.py: the weights' resolution (an explicit BENCH_PARAMS beats a decoy
checkpoint; a missing or incompatible one is an error), the knobs it
refuses, the watchdog's zero line, and a reduced run's JSON line (256
points, batch 2, 1 timed batch, 1 spline slot a shape instead of 12: the
decoders' CPU cost is a fixed 1,800 rows a slot). The BENCH_ABLATE arms'
reduced runs are in tests/test_torch_bench_arms*.py.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.cli import bench
from parsenet_tpu_torch.core.checkpoint import save_npz_params
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             init_flax_like, params_to_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = {"BENCH_POINTS": "256", "BENCH_BATCH": "2", "BENCH_ITERS": "1"}
torch.set_num_threads(1)


def _small():
    return PrimitivesEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)


def _write(path, shift=0.0, emb_size=16):
    model = PrimitivesEmbedding(emb_size=emb_size, num_primitives=10,
                                mode=5, k=4)
    init_flax_like(model, torch.Generator().manual_seed(0))
    flat = {k: v + shift for k, v in params_to_jax(model).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_npz_params(str(path), flat)
    return flat


def _first(model):
    return model.encoder.conv1.w_diff.weight.detach().numpy().T


def test_explicit_npz_beats_decoy_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write("logs/checkpoints/parsenet_e2e.npz", shift=0.0)
    cand = _write(tmp_path / "cand.npz", shift=1.0)
    model = _small()
    src, trained = bench.load_trained_params(model, str(tmp_path /
                                                        "cand.npz"))
    assert trained and src.endswith("cand.npz")
    np.testing.assert_array_equal(
        _first(model), cand["params/encoder/conv1/w_diff/kernel"])


@pytest.mark.parametrize("what", ["missing", "incompatible"])
def test_explicit_bad_npz_is_an_error(tmp_path, monkeypatch, what):
    monkeypatch.chdir(tmp_path)
    _write("logs/checkpoints/parsenet_e2e.npz")
    path = tmp_path / "cand.npz"
    if what == "incompatible":
        _write(path, emb_size=8)
    with pytest.raises(ValueError, match="BENCH_PARAMS"):
        bench.load_trained_params(_small(), str(path))


def test_unset_prefers_the_trainers_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    own = _write("logs/checkpoints/parsenet_e2e.npz", shift=2.0)
    _write("params/parsenet_e2e.npz", shift=3.0)
    model = _small()
    src, trained = bench.load_trained_params(model)
    assert trained and src == "logs/checkpoints/parsenet_e2e.npz"
    np.testing.assert_array_equal(
        _first(model), own["params/encoder/conv1/w_diff/kernel"])


def test_npz_fallback_then_seeded_init(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write("logs/checkpoints/parsenet_seg_normals.npz", emb_size=8)
    shipped = _write("params/parsenet_e2e.npz", shift=3.0)
    model = _small()
    assert bench.load_trained_params(model) == ("params/parsenet_e2e.npz",
                                                True)
    np.testing.assert_array_equal(
        _first(model), shipped["params/encoder/conv1/w_diff/kernel"])
    os.remove("params/parsenet_e2e.npz")
    assert bench.load_trained_params(_small()) == (None, False)


@pytest.mark.parametrize("env, knob", [
    ({"BENCH_STREAM": "c"}, "BENCH_STREAM"),
    ({"BENCH_SHARD": "1"}, "BENCH_SHARD"),
    ({"BENCH_PREFLIGHT": "1"}, "BENCH_PREFLIGHT"),
    ({"PARSENET_KNN_RECALL": "0.85"}, "PARSENET_KNN_RECALL"),
    ({"BENCH_ABLATE": "ms,nope"}, "BENCH_ABLATE"),
])
def test_knobs_the_port_cannot_honour_raise(env, knob):
    with pytest.raises(ValueError, match=knob):
        bench.settings(env)


def test_settings_defaults_and_stream_b():
    cfg = bench.settings({"BENCH_STREAM": "b", "BENCH_SHARD": "0",
                          "BENCH_ABLATE": "ms,coverage"})
    assert cfg["stream"] == "b" and cfg["ablate"] == ("ms", "coverage")
    assert (cfg["points"], cfg["batch"], cfg["iters"]) == (10000, 4, 8)
    assert cfg["ms_bf16"] and not cfg["dgcnn_bf16"]


def test_spline_dir_without_both_decoders_is_an_error(tmp_path):
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "open_splinenet.npz").write_bytes(b"")
    with pytest.raises(ValueError, match="BENCH_SPLINE_DIR"):
        bench.spline_decoders(str(tmp_path), "cpu")


def test_watchdog_prints_its_zero_line_and_exits_2():
    env = dict(os.environ, BENCH_WATCHDOG_S="1", BENCH_POINTS="2048",
               BENCH_BATCH="1", BENCH_ITERS="1")
    env.pop("PARSENET_KNN_RECALL", None)
    out = subprocess.run([sys.executable, "-m", "parsenet_tpu_torch.cli.bench",
                          "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, (out.returncode, out.stdout,
                                 out.stderr[-500:])
    rec = json.loads(next(ln for ln in out.stdout.splitlines()
                          if ln.startswith("{")))
    assert rec["metric"] == bench.METRIC and rec["value"] == 0.0
    assert "watchdog" in rec["detail"]["error"]


def test_reduced_run_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    # set when a test imports the JAX package's bench.py; refused here
    monkeypatch.delenv("PARSENET_KNN_RECALL", raising=False)
    for k, v in REDUCED.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_WATCHDOG_S", "0")
    monkeypatch.setattr(tp, "EVAL_SPLINE_SLOTS", 1)
    bench.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "torch_abc_shapes_per_hour_e2e"
    assert rec["unit"] == "shapes/hour" and rec["value"] > 0
    assert "vs_baseline" not in rec
    d = rec["detail"]
    assert d["floors_applied"] is False and d["quality_ok"] is True
    assert d["trained_params"] and d["params_src"] == \
        "params/parsenet_e2e.npz"
    assert (d["num_points"], d["batch"], d["timed_batches"]) == (256, 2, 1)
    assert d["stream_seed"] == 7 and d["card"] == "cpu"
    assert d["spline_src"] == "params" and d["ablate"] == ""
    for k in ("residual", "seg_iou", "p_cov", "sk_2", "per_shape_ms"):
        assert np.isfinite(d[k]), k
