"""The port's training-step bench (parsenet_tpu_torch.cli.bench_train) on
the CPU at toy size: the segmentation step (f32, bf16 with remat) and the
e2e step (plain, BT_FAST) each print one well-formed JSON line, and the
knobs the port cannot honour raise an error that names them.
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


@pytest.mark.parametrize("arm", [None, "fast"])
def test_e2e_bench(capsys, arm):
    env = dict(TOY_E2E, **({"BT_FAST": "1"} if arm == "fast" else {}))
    rec = bt.bench_e2e(env, steps=1, device="cpu")
    (line,) = _line(capsys)
    assert line["metric"] == rec["metric"] == \
        "torch_e2e_train_shapes_per_sec"
    d = rec["detail"]
    assert rec["value"] > 0 and np.isfinite(d["res_loss"])
    assert d["knn"] == "exact" and d["grad_ok"] == 1.0
    if arm == "fast":
        assert (d["spline_stride"], d["residual_stride"], d["siou_stride"],
                d["ms_att"]) == (4, 2, 2, 2)


@pytest.mark.parametrize("env, knob", [({"BT_KNN_RECALL": "0.85"},
                                        "BT_KNN_RECALL"),
                                       ({"BT_MS_PALLAS": "0"},
                                        "BT_MS_PALLAS")])
def test_refused_knobs_raise(env, knob):
    for fn in (bt.bench_seg, bt.bench_e2e):
        with pytest.raises(ValueError, match=knob):
            fn(env, device="cpu")


def test_unknown_arm_raises():
    """BT_ABLATE, any value: the port costs a stage from its timer and
    spans, not by running it stubbed."""
    for fn in (bt.bench_seg, bt.bench_e2e):
        with pytest.raises(ValueError, match="BT_ABLATE") as err:
            fn({"BT_ABLATE": "fit"}, device="cpu")
        assert "benchmark/run.py --trace 1" in str(err.value)


def test_empty_arm_is_the_full_path():
    """BT_ABLATE="" names no arm in the JAX bench; the port takes it as
    unset."""
    bt._refuse({"BT_ABLATE": ""})
