"""The port's training-step bench (parsenet_tpu_torch.cli.bench_train) on
the CPU at toy size: the segmentation step (f32, bf16 with remat), the e2e
step and its stage-costing arms each print one well-formed JSON line, and
the knobs the port cannot honour raise an error that names them.
"""
import json

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.cli import bench_train as bt

torch.set_num_threads(1)
TOY_SEG = {"BT_BATCH": "1", "BT_ACCUM": "2", "BT_POINTS": "256"}
TOY_E2E = {"BT_POINTS": "256", "BT_MS_SAMPLES": "128"}


def _line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    return [json.loads(ln) for ln in lines]


@pytest.mark.parametrize("knobs", [{}, {"BT_BF16": "1", "BT_REMAT": "1"}],
                         ids=["f32", "bf16_remat"])
def test_seg_bench(capsys, knobs):
    rec = bt.bench_seg(dict(TOY_SEG, **knobs), steps=1, device="cpu")
    assert _line(capsys) == [json.loads(json.dumps(rec))]
    d = rec["detail"]
    assert rec["metric"] == "torch_seg_train_shapes_per_sec"
    assert rec["value"] > 0 and d["grad_ok"] == 1.0
    assert (d["batch"], d["accum"], d["points"]) == (1, 2, 256)
    assert d["bf16"] == d["remat"] == bool(knobs)
    assert np.isfinite(d["embed_loss"]) and d["card"] == "cpu"


@pytest.mark.parametrize("arm", [None, "fast", "netgrad", "nograd"])
def test_e2e_bench(capsys, arm):
    env = dict(TOY_E2E, **({"BT_FAST": "1"} if arm == "fast" else {}))
    ablate = (arm,) if arm in ("netgrad", "nograd") else ()
    rec = bt.bench_e2e(env, steps=1, ablate=ablate, tag=arm or "",
                       device="cpu")
    (line,) = _line(capsys)
    assert line["metric"] == rec["metric"] == \
        "torch_e2e_train_shapes_per_sec" + (f"_{arm}" if arm else "")
    d = rec["detail"]
    assert rec["value"] > 0 and np.isfinite(d["res_loss"])
    assert d["knn"] == "exact" and d["ablate"] == ",".join(ablate)
    assert ("grad_ok" in d) == (arm != "nograd")
    if arm == "fast":
        assert (d["spline_stride"], d["residual_stride"], d["siou_stride"],
                d["ms_att"]) == (4, 2, 2, 2)


def test_e2e_ablate_prints_the_breakdown(capsys, monkeypatch):
    monkeypatch.setattr(bt, "E2E_ARMS", ("full", "fit", "splines"))
    rec = bt.bench_e2e_ablate(TOY_E2E, steps=1, device="cpu")
    lines = _line(capsys)
    assert [ln["metric"] for ln in lines] == [
        "torch_e2e_train_shapes_per_sec_full",
        "torch_e2e_train_shapes_per_sec_fit",
        "torch_e2e_train_shapes_per_sec_splines", "torch_e2e_ablation_ms"]
    assert lines[-1] == json.loads(json.dumps(rec))
    assert set(rec["detail"]) == {"cost_fit_ms", "cost_splines_ms", "card"}


@pytest.mark.parametrize("env, knob", [({"BT_KNN_RECALL": "0.85"},
                                        "BT_KNN_RECALL"),
                                       ({"BT_MS_PALLAS": "0"},
                                        "BT_MS_PALLAS")])
def test_refused_knobs_raise(env, knob):
    for fn in (bt.bench_seg, bt.bench_e2e):
        with pytest.raises(ValueError, match=knob):
            fn(env, device="cpu")


def test_unknown_arm_raises():
    with pytest.raises(ValueError, match="BT_ABLATE"):
        bt.bench_e2e({"BT_ABLATE": "nope"}, device="cpu")
