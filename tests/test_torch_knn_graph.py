"""The DGCNN's graph entry (ops/knn.knn_graph) and K6's plain version on
the CPU: the entry's CPU route is `knn` / `knn_points_normals` index for
index, K6's rule (score descending, equal scores index ascending) on
inputs whose scores tie exactly or hold a NaN, which graphs K6 takes on
the card,
and the encoder building its three graphs through the entry, one
`knn.graph` span each. K6 itself runs only on the card:
tests/test_torch_knn_graph_card.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.models.dgcnn import DGCNNEncoder
from parsenet_tpu_torch.ops import kernels, knn

torch.set_num_threads(1)

METRICS = [("xyz", False, 3), ("features", False, 64), ("joint", True, 6)]


def _cloud(b, n, c, points_normals, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    if points_normals:
        x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    return torch.from_numpy(x)


def _plain(x, k1, k2, points_normals):
    return (knn.knn_points_normals if points_normals else knn.knn)(x, k1, k2)


def _scores(x, points_normals):
    """[B, N, N] f32 scores in the plain route's operations (small N)."""
    if points_normals:
        p, nrm = x[..., :3], x[..., 3:6]
        pp = torch.sum(p * p, dim=-1)
        d_p = pp[..., None] - 2.0 * (p @ p.transpose(1, 2)) + pp[:, None, :]
        return -(d_p * (1.0 + (2.0 - 2.0 * (nrm @ nrm.transpose(1, 2)))))
    xx = torch.sum(x * x, dim=-1)
    return 2.0 * (x @ x.transpose(1, 2)) - xx[..., None] - xx[:, None, :]


def _rule(scores, k):
    """Each row's k best by score descending, equal scores index
    ascending: numpy's lexsort, independent of torch.topk."""
    s = scores.numpy()
    n = s.shape[-1]
    idx = np.arange(n)
    out = np.empty(s.shape[:-1] + (k,), np.int64)
    for b in range(s.shape[0]):
        for i in range(s.shape[1]):
            out[b, i] = np.lexsort((idx, -s[b, i]))[:k]
    return torch.from_numpy(out)


# N off the 64-point tile and row block, and the cells' 7,000 and 8,000
@pytest.mark.parametrize("name,points_normals,c", METRICS)
@pytest.mark.parametrize("b,n", [(3, 700), (1, 7000), (2, 8000)])
def test_cpu_route_is_the_plain_route(name, points_normals, c, b, n):
    x = _cloud(b, n, c, points_normals, seed=n + c)
    got = knn.knn_graph(x, 80, points_normals=points_normals)
    assert torch.equal(got, _plain(x, 80, 80, points_normals))


@pytest.mark.parametrize("name,points_normals,c", METRICS)
def test_plain_version_is_the_plain_graph_up_to_exact_ties(
        name, points_normals, c):
    """K6's plain version (what kernels.knn_graph runs for a CPU tensor)
    and the plain route pick neighbours of the same scores at every rank:
    they may differ only in the order of exactly equal scores."""
    x = _cloud(2, 700, c, points_normals, seed=c)
    got = kernels.knn_graph(x, 80, points_normals)
    ref = _plain(x, 80, 80, points_normals)
    s = _scores(x, points_normals)
    assert torch.equal(torch.gather(s, 2, got), torch.gather(s, 2, ref))
    assert torch.equal(got, _rule(s, 80))


@pytest.mark.parametrize("name,points_normals,c", METRICS)
def test_tie_order_on_duplicated_points(name, points_normals, c):
    """Every point twice (j and j + N / 2) on an integer grid, so scores tie
    exactly within and across the copies: K6's rule takes the tied
    neighbours in ascending index, the copies of one point included."""
    rng = np.random.RandomState(5)
    half = rng.randint(-3, 4, size=(2, 150, c)).astype(np.float32)
    if points_normals:
        half[..., 3:] = np.eye(3, dtype=np.float32)[rng.randint(0, 3,
                                                                (2, 150))]
    x = torch.from_numpy(np.concatenate([half, half], 1))
    got = kernels.knn_graph(x, 80, points_normals)
    s = _scores(x, points_normals)
    assert torch.equal(got, _rule(s, 80))
    # a point's two copies score alike from every query: the lower index
    # comes first
    for b in range(2):
        for i in range(0, 300, 37):
            row = got[b, i].tolist()
            for j in row:
                if j >= 150 and j - 150 in row:
                    assert row.index(j - 150) < row.index(j)


@pytest.mark.parametrize("name,points_normals,c", METRICS)
def test_plain_version_ranks_a_nan_score_first(name, points_normals, c):
    """One point of NaNs: every score against it is NaN, which torch.topk
    ranks above every number. In each other row it is the first
    neighbour and the rest is the plain route's; its own row is all NaN,
    so by K6's rule its graph is the first k indices."""
    x = _cloud(2, 300, c, points_normals, seed=11)
    x[1, 37] = float("nan")
    got = kernels.knn_graph(x, 80, points_normals)
    ref = _plain(x, 80, 80, points_normals)
    assert torch.equal(got[1, 37], torch.arange(80))
    others = torch.ones((2, 300), dtype=torch.bool)
    others[1, 37] = False
    assert bool((got[1][others[1]][:, 0] == 37).all())
    assert torch.equal(got[others], ref[others])


@pytest.mark.parametrize("case,want", [
    (dict(), True),
    (dict(k=1), True),
    (dict(k=32), True),                # torch.topk may order ties otherwise
    (dict(k=128), True),
    (dict(k=129), False),              # past the kernel's list
    (dict(dtype=torch.bfloat16), False),
    (dict(c=5), False),                # a width without an instance
    (dict(c=3), True),
    (dict(c=6), False),                # 6 channels on the squared distance
    (dict(c=6, points_normals=True), True),
    (dict(c=64, points_normals=True), False),
    (dict(n=60), False),               # fewer points than k
    (dict(k=0), False),
])
def test_which_graphs_k6_builds(case, want):
    """The entry's one routing rule on the card: K6 wherever the kernel
    takes the graph."""
    args = dict(k=80, dtype=torch.float32, c=64, n=200, points_normals=False)
    args.update(case)
    x = torch.zeros((2, args["n"], args["c"]), dtype=args["dtype"])
    assert kernels.knn_graph_fits(x, args["k"],
                                  args["points_normals"]) is want


def test_k2_above_k1_keeps_the_plain_route(monkeypatch):
    """The DGCNN's entry builds no dilated graph: a k2 is refused there,
    and `knn`'s dilation (every other of the 16 nearest) never reaches
    K6."""
    x = _cloud(2, 300, 64, False, seed=3)

    def refuse(*a, **kw):
        raise AssertionError("K6 called for a dilated graph")
    monkeypatch.setattr(kernels, "knn_graph", refuse)
    with pytest.raises(TypeError):
        knn.knn_graph(x, 8, 16)
    assert torch.equal(knn.knn(x, 8, 16), knn.knn(x, 16)[..., ::2])


def test_k6_wrapper_refuses_what_it_cannot_run():
    meta = torch.empty((2, 100, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.knn_graph(meta, 80)
    x = _cloud(2, 100, 64, False).requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        kernels.knn_graph(x, 80)
    with torch.no_grad():   # the DGCNN's entry is no_grad itself
        assert knn.knn_graph(x, 80).shape == (2, 100, 80)


@pytest.mark.parametrize("mode", [0, 5])
def test_encoder_builds_three_graphs_through_the_entry(monkeypatch, mode):
    enc = DGCNNEncoder(mode=mode, k=16)
    x = _cloud(2, 128, 6 if mode == 5 else 3, mode == 5, seed=1)
    seen = []
    entry = knn.knn_graph

    def record(v, k, *, points_normals=False):
        seen.append((v.shape[2], k, points_normals))
        return entry(v, k, points_normals=points_normals)
    monkeypatch.setattr(knn, "knn_graph", record)
    with torch.no_grad():
        enc(x)
    assert seen == [(x.shape[2], 16, mode == 5), (64, 16, False),
                    (64, 16, False)]


def test_one_knn_graph_span_a_graph():
    enc = DGCNNEncoder(mode=5, k=16)
    x = _cloud(2, 128, 6, True, seed=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            enc(x)
    names = [e.name for e in prof.events()]
    assert names.count("knn.graph") == 3
