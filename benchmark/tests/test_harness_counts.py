"""The counts against hand-worked numbers, and the readers' arithmetic."""
from __future__ import annotations

import pytest

from benchmark import counts
from benchmark.trace import Reading, union_us


def test_k1_of_a_stream_a_shape():
    # 10,000^2 x 128 x 4 x 50 = 2.56 TFLOP, 5e9 exponentials, 10.24 MB
    c = counts.mean_shift_counts(10000, 128, 50)
    assert c["flops"] == 2.56e12
    assert c["exps"] == 5e9
    assert c["bytes"] == 2 * 10000 * 128 * 4
    # bound by the products: 2.56e12 / 989e12 s
    assert counts.least_seconds(c) == pytest.approx(2.56e12 / 989e12)


def test_dgcnn_forward_by_hand():
    n = 1000
    knn = 2 * n * n * 3 * 2 + 2 * (2 * n * n * 64)
    edge = 2 * 2 * n * (6 * 64 + 64 * 64 + 64 * 128)
    dense = 2 * n * (256 * 1024 + 1280 * 512 + 512 * 256 + 256 * 256
                     + 256 * 128 + 256 * 256 + 256 * 10)
    assert counts.dgcnn_forward_flops(n) == knn + edge + dense


def test_splinenet_open_by_hand():
    m = 100
    knn = 2 * m * m * (3 + 64 + 64 + 128)
    edge = 2 * 2 * m * (3 * 64 + 64 * 64 + 64 * 128 + 128 * 256)
    tail = 2 * m * 512 * 1024 + 2 * (2 * 1024 * 1024) + 2 * 1024 * 1200
    assert counts.splinenet_forward_flops(m, False) == knn + edge + tail


def test_readers_arithmetic():
    r = Reading("infer", {"dgcnn": 40.0, "mean_shift": 20.0}, 8, 2, 2.0,
                {"flops_per_shape": 989e12 / 100.0,
                 "mean_shift": counts.mean_shift_counts(1000, 128, 10)},
                None)
    assert r.per_unit("dgcnn") == 5.0
    assert r.per_unit("spline") is None
    assert r.mfu() == pytest.approx(4.0)
    assert r.idle_share() is None and r.mean_shift_roofline() is None
    t = Reading("train", {"backward": 30.0}, 8, 3, 1.0,
                {"flops_per_shape": 1.0}, None)
    assert t.per_unit("backward") == 10.0
    assert union_us([(0, 2), (1, 3), (5, 6)])[0] == 4
