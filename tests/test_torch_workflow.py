"""Port parity: the route from training to shipped weights (the CLIs
cli.finetune_e2e, export_params, promote_candidate, make_synthetic_data,
train_workflow, validate_reference, fetch_dataset and data_day_drill)
against the JAX-side scripts they mirror, on the CPU at small sizes.

* export: the same flat weights give the same npz arrays and dtypes as
  scripts/export_params.export (its checkpoint reader replaced by one
  that hands it the flat dict), bit for bit, and cli.bench loads them;
* the gate: one set of hand-made bench JSONs, both scripts as
  subprocesses: the same exit codes and the same files copied;
* make_synthetic_data: the JAX package's writers' h5 files, bit for bit;
* train_workflow: each trainer stage's derived config and command;
* validate_reference: its two stages on 2 shapes of 1,024 points (the
  shipped weights and decoders, one spline slot a shape on both sides,
  the clusters renumbered by first appearance on both) against the JAX
  script run in process with the script's own draws handed to the port:
  seg_iou and prim_iou within 1e-4, residual within
  1e-3 relative, cov, sk_1 and sk_2 within 1e-3 (tests/test_torch_cli.py's
  tolerances);
* the drill end to end through h5 files and a file:// fixture, and the
  fine-tune's route (a 1-step fine-tune from the shipped weights, its
  export, cli.bench's loader), on the CPU;
* the entry points that run a network refuse to start without a card.
"""
import functools
import importlib.util
import json
import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.data import synthetic as jsyn
from parsenet_tpu.eval import pipeline as jp
from parsenet_tpu_torch.cli import bench as cbench
from parsenet_tpu_torch.cli import data_day_drill as cdrill
from parsenet_tpu_torch.cli import export_params as cexport
from parsenet_tpu_torch.cli import finetune_e2e as cft
from parsenet_tpu_torch.cli import make_synthetic_data as cmake
from parsenet_tpu_torch.cli import test as ctest
from parsenet_tpu_torch.cli import train_workflow as cwf
from parsenet_tpu_torch.cli import validate_reference as cval
from parsenet_tpu_torch.cli.generate_predictions import load_test_split
from parsenet_tpu_torch.core.checkpoint import (load_npz_params,
                                                save_npz_params,
                                                unflatten_tree)
from parsenet_tpu_torch.core.config import load_config
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.fitting.spline_apply import trained_spline_fit
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             load_primitives_embedding)
from parsenet_tpu_torch.ops.preprocess import BUF
from test_torch_slice import canonical

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- export

def test_export_matches_the_scripts_rule(tmp_path, monkeypatch):
    """A SplineNet-like flat dict (params and batch_stats) through both."""
    flat = dict(load_npz_params(os.path.join(REPO, "params",
                                             "open_splinenet.npz")))
    assert any(k.startswith("batch_stats") for k in flat)
    save_npz_params(str(tmp_path / "ck.npz"), flat)
    assert cexport.export(str(tmp_path / "ck.npz"), str(tmp_path / "port.npz"))

    from parsenet_tpu.core import checkpoint as jck

    class Restored:                       # the orbax reader, handing over
        def __init__(self, path):         # the same flat weights
            pass

        def latest_step(self):
            return 1

        def restore(self, target):
            return unflatten_tree(flat)

    monkeypatch.setattr(jck, "Checkpointer", Restored)
    assert _script("export_params").export("ck", str(tmp_path / "jax.npz"),
                                           None)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == (
                np.float16 if k.startswith("params") else np.float32), k
            np.testing.assert_array_equal(a[k], b[k])


def test_export_cli_modes_and_bench_loads_the_export(tmp_path):
    logs = tmp_path / "logs" / "checkpoints"
    with pytest.raises(SystemExit) as e:
        cexport.main(["--log-dir", str(tmp_path / "logs"), "--e2e-ckpt",
                      "absent", "--e2e-out", str(tmp_path / "x.npz")])
    assert e.value.code == 1
    shipped = load_npz_params(PARAMS)
    save_npz_params(str(logs / "parsenet_seg_normals.npz"), shipped)
    for name in ("open_splinenet", "closed_splinenet"):
        save_npz_params(str(logs / f"{name}.npz"), load_npz_params(
            os.path.join(REPO, "params", f"{name}.npz")))
    out = tmp_path / "out"
    cexport.main(["--log-dir", str(tmp_path / "logs"), "--e2e-out",
                  str(out / "e2e.npz"), "--spline-out-prefix",
                  str(out) + "/cand_"])
    assert sorted(os.listdir(out)) == ["cand_closed_splinenet.npz",
                                       "cand_open_splinenet.npz", "e2e.npz"]
    model = PrimitivesEmbedding(emb_size=128, num_primitives=10, mode=5,
                                k=80)
    src, trained = cbench.load_trained_params(model, str(out / "e2e.npz"))
    assert trained and src == str(out / "e2e.npz")
    # the shipped export was f16 already: the round trip keeps every bit
    with np.load(out / "e2e.npz") as a, np.load(PARAMS) as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---- the gate

def _detail(stream="a", seg_iou=0.89, sk_2=0.86, num_points=10000,
            trained=True, quality_ok=True, **extra):
    d = {"stream": stream, "seg_iou": seg_iou, "sk_2": sk_2,
         "residual": 0.011, "num_points": num_points,
         "trained_params": trained, "quality_ok": quality_ok,
         "floors_applied": True, "ablate": "", "spline_src": "params"}
    d.update(extra)
    return {"metric": "torch_abc_shapes_per_hour_e2e", "value": 28000.0,
            "detail": d}


GATE_CASES = {
    "green": ({}, []),
    "floors_not_applied": ({"a": _detail(floors_applied=False)}, []),
    "stream_b_below_noise": ({"b": _detail(stream="b", seg_iou=0.83)}, []),
    "missing_file": ({"missing": True}, []),
    "bundle": ({"a": _detail(spline_src="logs/checkpoints"),
                "b": _detail(stream="b", spline_src="logs/checkpoints")},
               ["--cand-spline-prefix"]),
    "bundle_decoder_missing": ({"a": _detail(spline_src="logs/checkpoints"),
                                "drop_decoder": True},
                               ["--cand-spline-prefix"]),
    "jax_bench_record": ({"a": {"parsed": {**_detail(),
                                           "metric": "abc_shapes_per_hour_e2e"}}},
                         []),
}


def _gate(root, case, cmd):
    over, extra = GATE_CASES[case]
    root.mkdir()
    (root / "cand.npz").write_bytes(b"E2E")
    for n in ("open_splinenet", "closed_splinenet"):
        if not (over.get("drop_decoder") and n == "closed_splinenet"):
            (root / f"cand_{n}.npz").write_bytes(b"DEC-" + n.encode())
    (root / "params").mkdir()
    files = {"a": over.get("a", _detail()),
             "b": over.get("b", _detail(stream="b")),
             "sb": _detail(stream="b", seg_iou=0.858, sk_2=0.833),
             "sa": _detail(seg_iou=0.8732)}
    for k, v in files.items():
        (root / f"{k}.json").write_text(json.dumps(v))
    if over.get("missing"):
        os.remove(root / "b.json")
    args = ["--cand", str(root / "cand.npz"), "--gate-a", str(root / "a.json"),
            "--gate-b", str(root / "b.json"), "--shipped-b",
            str(root / "sb.json"), "--shipped-a-json", str(root / "sa.json"),
            "--dest", str(root / "params" / "parsenet_e2e.npz"),
            "--params-dir", str(root / "params"), "--bank",
            str(root / "bank")]
    if extra:
        args += [extra[0], str(root / "cand_")]
    r = subprocess.run(cmd + args, capture_output=True, text=True, cwd=REPO)
    copied = {str(p.relative_to(root)): p.read_bytes()
              for p in sorted(root.rglob("*"))
              if p.is_file() and p.parent.name in ("params", "bank")}
    return r.returncode, copied, r.stdout


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_matches_the_script(tmp_path, case):
    jrc, jcopied, jout = _gate(tmp_path / "jax", case, [
        sys.executable, os.path.join(REPO, "scripts", "promote_candidate.py")])
    rc, copied, out = _gate(tmp_path / "port", case, [
        sys.executable, "-m", "parsenet_tpu_torch.cli.promote_candidate"])
    assert rc == jrc, (out, jout)
    assert copied == jcopied
    assert [ln for ln in out.splitlines() if "[" in ln] == \
        [ln for ln in jout.splitlines() if "[" in ln]
    want = {"green": 0, "bundle": 0, "jax_bench_record": 0,
            "floors_not_applied": 1, "stream_b_below_noise": 1,
            "missing_file": 2, "bundle_decoder_missing": 2}[case]
    assert rc == want
    assert ("params/parsenet_e2e.npz" in copied) == (want == 0)


# ---- data and the workflow

def test_make_synthetic_data_matches_the_jax_writers(tmp_path):
    cmake.main(["--shapes", "12", "--splines", "3", "--points", "64",
                "--out", str(tmp_path / "port")])
    ref = tmp_path / "jax"
    for split, n, seed in (("train", 12, 0), ("val", 8, 1), ("test", 8, 2)):
        jsyn.write_abc_h5(str(ref / "shapes" / f"{split}_data.h5"), n,
                          num_points=64, seed=seed)
    jsyn.write_spline_h5(str(ref / "spline" / "open_splines.h5"), 3,
                         num_points=700, seed=3)
    jsyn.write_spline_h5(str(ref / "spline" / "closed_splines.h5"), 3,
                         num_points=700, closed=True, seed=4)
    for rel in ("shapes/train_data.h5", "shapes/val_data.h5",
                "shapes/test_data.h5", "spline/open_splines.h5",
                "spline/closed_splines.h5"):
        with h5py.File(tmp_path / "port" / rel) as a, \
                h5py.File(ref / rel) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k][()], b[k][()])


def test_workflow_stages(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="unknown stage"):
        cwf.main(["sideways"])
    want = {"open": dict(num_train=440, num_val=36, num_epochs=20),
            "closed": dict(num_train=440, num_val=36, num_epochs=20),
            "seg": dict(num_train=960, num_val=160, num_epochs=40,
                        batch_size=1, accum=6),
            "e2e": dict(num_train=180, num_val=160, num_epochs=10)}
    for name, kw in want.items():
        for bf16 in (False, True):
            cmd = cwf.stage_command(name, "cpu", bf16)
            assert cmd[1:3] == ["-m", "parsenet_tpu_torch.cli."
                                + cwf.TRAINERS[name][2]]
            assert cmd[-2:] == ["--device", "cpu"]
            cfg = load_config(cmd[3])
            assert cfg == cwf.stage_config(name, bf16)
            for k, v in kw.items():
                assert getattr(cfg, k) == v, (name, k)
            assert cfg.half_precision == (bf16 and name in ("seg", "e2e"))
    assert "make_synthetic_data" in " ".join(cwf.stage_command("data"))


# ---- the validation harness

N_VAL, SHAPES_VAL = 1024, 2


def _eval_config(tmp_path, shapes=SHAPES_VAL, points=N_VAL, seed=13):
    data = tmp_path / "shapes"
    for split in ("val", "test"):
        jsyn.write_abc_h5(str(data / f"{split}_data.h5"), shapes,
                          num_points=points, seed=seed)
    path = tmp_path / "config.yml"
    path.write_text(f"""[train]
model_path = "parsenet_e2e"
dataset = "{data}/"
log_dir = "{tmp_path}/logs"
normals = True
num_val = {shapes}
num_test = {shapes}
num_points = {points}
grid_size = 20
batch_size = 1
mode = 5
knn_k = 80
""")
    return str(path)


def _script_draws(cfg, n_shapes, n, slots):
    """The draws of scripts/validate_reference.py: per shape key, k1, k2 =
    split(key, 3) from PRNGKey(seed); reconstruct_shape's coverage from
    fold_in(k2, 7), each slot's packing and final draw from split(k2)."""
    key, out = jax.random.PRNGKey(cfg.seed), []
    for _ in range(n_shapes):
        key, _, k2 = jax.random.split(key, 3)
        cov = np.asarray(jax.random.uniform(jax.random.fold_in(k2, 7),
                                            (jp.COV_SAMPLES,)))
        split = [jax.random.split(k) for k in jax.random.split(k2, slots)]
        u_pack = np.stack([np.asarray(jax.random.uniform(a, (n,)))
                           for a, _ in split])
        u_draw = np.stack([np.asarray(jax.random.uniform(b, (min(n, BUF),)))
                           for _, b in split])
        out.append((torch.from_numpy(cov), (torch.from_numpy(u_pack),
                                            torch.from_numpy(u_draw))))
    return out


def test_validate_reference_matches_the_script(tmp_path, monkeypatch,
                                               capsys):
    cfg_path = _eval_config(tmp_path)
    # the script in process, one spline slot a shape
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       jax.config.jax_compilation_cache_dir or "")
    monkeypatch.setenv("PARSENET_KNN_EXACT", "1")
    monkeypatch.setattr(jp, "reconstruct_shape", functools.partial(
        jp.reconstruct_shape, max_spline_slots=1))
    # both sides renumber the clusters by first appearance before the
    # reconstruction: the coverage draw falls on the surface samples in
    # segment order, and which point of a mode names its cluster rides on
    # last bits (tests/test_torch_slice.py compares canonical labels)
    predict = jp.predict_segmentation
    monkeypatch.setattr(jp, "predict_segmentation", lambda *a, **k: (
        lambda p: p._replace(labels=jnp.asarray(canonical(p.labels),
                                                jnp.int32)))(
        predict(*a, **k)))
    predict_split = cval.predict_split

    def canonical_split(*a, **k):
        out = predict_split(*a, **k)
        out["seg_id"] = np.stack([canonical(s).astype(np.int32)
                                  for s in out["seg_id"]])
        return out

    monkeypatch.setattr(cval, "predict_split", canonical_split)
    monkeypatch.setattr(sys, "argv", ["validate_reference.py", cfg_path,
                                      "--params", PARAMS])
    _script("validate_reference").main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    cfg = load_config(cfg_path)
    points, labels, normals, prim = load_test_split(cfg)
    agg = cval.validate_split(
        load_primitives_embedding(PARAMS, device="cpu"), points, normals,
        labels, prim, trained_spline_fit(cfg.log_dir, 20, "cpu"),
        generator=torch.Generator().manual_seed(0),
        draws=_script_draws(cfg, SHAPES_VAL, N_VAL, 1), device="cpu")
    with open(cval.EXPECTED) as f:
        got = cval.parity_table(agg, json.load(f))
    print(ref, got)
    assert got["n_shapes"] == ref["n_shapes"] == SHAPES_VAL
    assert got["floors_protocol"] == ref["floors_protocol"]
    for g, r in zip(got["rows"], ref["rows"]):
        assert g["metric"] == r["metric"]
        k, a, b = g["metric"], g["measured"], r["measured"]
        if k in ("seg_iou", "prim_iou"):
            assert abs(a - b) <= 1e-4, (k, a, b)
        elif k == "residual":
            assert abs(a - b) <= 1e-3 * abs(b), (k, a, b)
        else:
            assert abs(a - b) <= 1e-3, (k, a, b)


def _one_slot(monkeypatch):
    monkeypatch.setattr(tp, "EVAL_SPLINE_SLOTS", 1)
    monkeypatch.setattr(ctest, "EVAL_SPLINE_SLOTS", 1)


def test_data_day_drill_is_green_on_the_cpu(tmp_path, monkeypatch, capsys):
    """fetch from a file:// fixture, the sha256 pins, the schema check and
    the parity table through h5 files, one shape of 1,024 points."""
    _one_slot(monkeypatch)
    summary = cdrill.main(["--workdir", str(tmp_path / "drill"), "--points",
                           "1024", "--shapes", "4", "--eval-shapes", "1",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== parity vs" in out and "drill: GREEN" in out
    assert summary["n_shapes"] == 1 and len(summary["rows"]) == 6
    assert all(np.isfinite(r["measured"]) for r in summary["rows"])
    assert not (tmp_path / "drill").exists()


def test_validate_reference_cli_no_preprocess(tmp_path, monkeypatch,
                                              capsys):
    _one_slot(monkeypatch)
    summary = cval.main([_eval_config(tmp_path, shapes=1), "--params",
                         PARAMS, "--no-preprocess", "--device", "cpu"])
    assert summary["n_shapes"] == 1
    assert all(np.isfinite(r["measured"]) for r in summary["rows"])
    with pytest.raises(SystemExit):
        cval.main([_eval_config(tmp_path, shapes=1), "--params",
                   str(tmp_path / "absent.npz"), "--device", "cpu"])


# ---- the fine-tune's route

def test_finetune_route_on_the_cpu(tmp_path):
    """cli.finetune_e2e's config is the script's; one step from the
    shipped weights selects on a fixed sample at val_points and writes
    the checkpoint, whose export cli.bench loads."""
    cfg = cft.finetune_config(epochs=1)
    assert (cfg.num_train, cfg.num_val, cfg.num_test, cfg.lr,
            cfg.model_path, cfg.pretrain_model_path, cfg.accum, cfg.knn_k,
            cfg.batch_size, cfg.num_points, cfg.mode) == (
        180, 160, 160, 5e-5, "parsenet_e2e_ft", "", 5, 80, 1, 8000, 5)
    cfg = cft.finetune_config(epochs=1, accum=1, knn_k=8,
                              log_dir=str(tmp_path / "logs"))
    data = jsyn.make_shape_batch(np.random.RandomState(3), 3, 768)
    batches = [tuple(a[i:i + 1] for a in data) for i in range(3)]
    res = cft.finetune(cfg, val_shapes=1, val_points=768,
                       train_gen=iter(batches[:1]),
                       val_gen=iter(batches[1:]), steps_per_epoch=1,
                       points_per_shape=256, device="cpu")
    assert res.steps[0]["grad_ok"] == 1.0
    assert np.isfinite(res.epochs[0]["val_seg_iou"])
    ck = tmp_path / "logs" / "checkpoints" / "parsenet_e2e_ft.npz"
    assert ck.exists()
    cexport.main(["--log-dir", str(tmp_path / "logs"), "--e2e-ckpt",
                  "parsenet_e2e_ft", "--e2e-out", str(tmp_path / "c.npz")])
    model = PrimitivesEmbedding(emb_size=128, num_primitives=10, mode=5,
                                k=80)
    assert cbench.load_trained_params(model, str(tmp_path / "c.npz"))[1]


def test_route_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for call in (lambda: cft.main(["--epochs", "1"]),
                 lambda: cval.main([_eval_config(tmp_path, shapes=1)]),
                 lambda: cdrill.main(["--workdir", str(tmp_path / "d")]),
                 lambda: cwf.main(["seg"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "d").exists()


def test_chip_smoke_gate_never_writes_params(tmp_path):
    """chip_smoke.py phase 10's gate (run_gate) on green records: the
    candidate is promoted into the temporary directory, and every file of
    params/ keeps its sha256."""
    sys.path.insert(0, REPO)
    import chip_smoke
    before = chip_smoke.params_digest()
    cand = tmp_path / "cand_e2e.npz"
    cand.write_bytes(b"E2E")
    recs = {"cand_a": _detail(), "cand_b": _detail(stream="b"),
            "shipped_b": _detail(stream="b", seg_iou=0.858, sk_2=0.833),
            "shipped_a": _detail(seg_iou=0.8732)}
    code, text = chip_smoke.run_gate(recs, str(cand), str(tmp_path))
    assert code == 0, text
    assert (tmp_path / "gate" / "params" / "parsenet_e2e.npz").read_bytes() \
        == b"E2E"
    recs["cand_a"] = _detail(seg_iou=0.80, quality_ok=False)
    assert chip_smoke.run_gate(recs, str(cand), str(tmp_path / "2"))[0] == 1
    assert chip_smoke.params_digest() == before
