"""On the card: K6 (csrc/knn_graph.cu, the DGCNN's k-NN graphs) held to the
plain route (ops/knn.py: knn, knn_points_normals, torch.topk on the card)
index for index at every DGCNN cell's shape, on inputs with exact ties
or a NaN point, and the network's outputs with K6 to the plain route's
bit for bit.
Imports no JAX: on the card run

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_knn_graph_card.py
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# e2e-segment's pool (benchmark/mixes/segment-10k-b4.json): its seed
POOL_SEED = 1002


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("runs the CUDA kernels: needs a CUDA card")
    from parsenet_tpu_torch.ops import kernels
    kernels.build_kernels()
    return torch.device("cuda", 0)


def _pool(count, n, seed=POOL_SEED):
    """The first `count` shapes of a pool drawn as the benchmark draws its
    own (RandomState(seed), canonicalised): points + normals [count, n,
    6] f32 numpy."""
    from parsenet_tpu_torch.data.abc import normalize_points
    from parsenet_tpu_torch.data.synthetic import make_shape
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        pts, _, nrm, _ = make_shape(rng, n)
        p, q, _, _ = normalize_points(pts, nrm)
        out.append(np.concatenate([p, q], 1).astype(np.float32))
    return np.ascontiguousarray(np.stack(out))


def _model(device):
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    return load_primitives_embedding(
        os.path.join(REPO, "params", "parsenet_e2e.npz"), mode=5,
        device=device)


def _graph_inputs(model, x):
    """The three graphs' inputs of one forward of `model` on x: the points
    and normals, x1 and x2 (64 channels each)."""
    from parsenet_tpu_torch.ops import knn
    seen = []
    orig = knn.knn_graph

    def record(v, k, *, points_normals=False):
        seen.append((v.detach().clone(), points_normals))
        return orig(v, k, points_normals=points_normals)
    knn.knn_graph = record
    try:
        with torch.no_grad():
            model(x)
    finally:
        knn.knn_graph = orig
    return seen


def _plain(x, k, points_normals):
    from parsenet_tpu_torch.ops import knn
    return (knn.knn_points_normals if points_normals else knn.knn)(x, k, k)


def _held(x, k, points_normals):
    """K6's graph, the plain route's and the plain version's (K6's rule)
    on x: K6 must equal both, index for index."""
    from parsenet_tpu_torch.ops import kernels
    kernels.reset_launches()
    got = kernels.knn_graph(x, k, points_normals)
    assert kernels.LAUNCHES["K6"] == 1
    ref = _plain(x, k, points_normals)
    rows = (got != ref).any(-1)
    assert not bool(rows.any()), (
        f"{tuple(x.shape)}: {int(rows.sum())} of {rows.numel()} rows "
        f"({100.0 * float(rows.float().mean()):.4f}%) differ from the plain "
        "route")
    assert torch.equal(got, kernels.knn_graph_plain(x, k, points_normals))


# (clouds, points): e2e-segment and e2e-protocol, normals-train, e2e-train
@pytest.mark.parametrize("b,n", [(4, 10000), (24, 7000), (5, 8000)])
def test_k6_graphs_match_the_plain_route(card, b, n):
    """The joint graph of every cloud, and the three graphs of the first
    four with the shipped network's own features (x1, x2)."""
    x = torch.from_numpy(_pool(b, n, seed=POOL_SEED + n)).to(card)
    _held(x, 80, True)
    seen = _graph_inputs(_model(card), x[:4])
    assert [(v.shape[2], pn) for v, pn in seen] == [(6, True), (64, False),
                                                    (64, False)]
    for v, points_normals in seen:
        _held(v.contiguous(), 80, points_normals)


def test_k6_xyz_graph_matches_the_plain_route(card):
    """Mode 0's first graph: squared distance on the points alone."""
    x = torch.from_numpy(np.ascontiguousarray(_pool(4, 10000)[..., :3])).to(
        card)
    _held(x, 80, False)


def test_torch_topk_tie_order_on_the_card(card):
    """What the plain route's torch.topk(..., sorted=True) returns among
    exactly tied scores at k = 80 on the card: score descending, equal
    scores index ascending, the lowest indices of a tie at the k-th taken
    (knn.topk_first's order, K6's rule)."""
    from parsenet_tpu_torch.ops import knn
    rng = np.random.RandomState(3)
    s = torch.from_numpy(rng.randint(-40, 0, size=(64, 10000)).astype(
        np.float32)).to(card)
    got = torch.topk(s, 80, dim=-1, sorted=True).indices
    assert torch.equal(got, knn.topk_first(s, 80))


@pytest.mark.parametrize("points_normals,c", [(False, 3), (False, 64),
                                              (True, 6)])
def test_k6_tie_order_on_duplicated_points(card, points_normals, c):
    """Every point twice (j and j + N / 2) on an integer grid, so scores
    tie exactly across and within copies: K6's graph and order are
    torch.topk's."""
    rng = np.random.RandomState(7)
    half = rng.randint(-4, 5, size=(2, 2500, c)).astype(np.float32)
    if points_normals:
        half[..., 3:] = np.eye(3, dtype=np.float32)[rng.randint(0, 3,
                                                                (2, 2500))]
    x = torch.from_numpy(np.concatenate([half, half], 1)).to(card)
    _held(x, 80, points_normals)


@pytest.mark.parametrize("n", [100, 1000, 2049])
def test_k6_ragged_sizes_and_k(card, n):
    """N not a multiple of a tile or a row block, k from 1 to 128: K6's
    graph is its rule's (`knn_graph_plain`) at every k, and the plain
    route's neighbours rank by rank, their scores bit for bit. Index for
    index at k = 80 and 128; below, torch.topk may order an exact tie
    otherwise (it does at k = 17 in one of these 6,147 rows at n =
    2,049), where K6 keeps its rule, lax.top_k's."""
    from parsenet_tpu_torch.ops import kernels
    rng = np.random.RandomState(n)
    x = torch.from_numpy(rng.randn(3, n, 64).astype(np.float32)).to(card)
    # the plain route's scores, in its operations (one chunk: n <= 2,500)
    xx = torch.sum(x * x, dim=-1)
    s = 2.0 * (x @ x.transpose(1, 2)) - xx[..., None] - xx[:, None, :]
    for k in (1, 17, 32, 80, min(128, n)):
        if k >= 80:
            _held(x, k, False)
            continue
        got = kernels.knn_graph(x, k, False)
        assert torch.equal(got, kernels.knn_graph_plain(x, k, False))
        ref = _plain(x, k, False)
        assert torch.equal(torch.gather(s, 2, got), torch.gather(s, 2, ref))


@pytest.mark.parametrize("points_normals,c", [(False, 3), (False, 64),
                                              (True, 6)])
def test_k6_ranks_a_nan_point_as_torch_topk_does(card, points_normals, c):
    """One point of NaNs in a cloud of 3,000 (its scores all NaN, ranked
    above every number): every index K6 writes is a point of the cloud,
    its graph is its rule's everywhere, and the plain route's in every
    row but the NaN point's own (all NaN there, a tie torch.topk breaks
    its own way)."""
    from parsenet_tpu_torch.ops import kernels, knn
    rng = np.random.RandomState(c)
    x = rng.randn(2, 3000, c).astype(np.float32)
    if points_normals:
        x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    x[1, 1234] = np.nan
    x = torch.from_numpy(x).to(card)
    got = kernels.knn_graph(x, 80, points_normals)
    assert bool(((got >= 0) & (got < 3000)).all())
    assert torch.equal(got, kernels.knn_graph_plain(x, 80, points_normals))
    assert torch.equal(got[1, 1234], torch.arange(80, device=card))
    ref = _plain(x, 80, points_normals)
    others = torch.ones((2, 3000), dtype=torch.bool, device=card)
    others[1, 1234] = False
    assert bool((got[1][others[1]][:, 0] == 1234).all())
    assert torch.equal(got[others], ref[others])
    # the entry takes K6 for it as for any other graph
    kernels.reset_launches()
    assert torch.equal(knn.knn_graph(x, 80, points_normals=points_normals),
                       got)
    assert kernels.LAUNCHES["K6"] == 1


def test_network_outputs_bitwise_with_k6(card):
    """PrimitivesEmbedding on 8 of e2e-segment's pool shapes (2 requests of
    4): embedding and type log-probs with K6 equal the plain route's bit
    for bit, and K6 launches 3 times a request."""
    from parsenet_tpu_torch.ops import kernels, knn
    x = torch.from_numpy(_pool(8, 10000)).to(card)
    model = _model(card)
    orig = knn.knn_graph
    for s in (0, 4):
        kernels.reset_launches()
        with torch.no_grad():
            emb, logp = model(x[s:s + 4])
        assert kernels.LAUNCHES["K6"] == 3
        knn.knn_graph = lambda v, k, *, points_normals=False: \
            _plain(v, k, points_normals)
        try:
            with torch.no_grad():
                emb_p, logp_p = model(x[s:s + 4])
        finally:
            knn.knn_graph = orig
        assert torch.equal(emb, emb_p) and torch.equal(logp, logp_p), (
            s, float((emb - emb_p).abs().max()),
            float((logp - logp_p).abs().max()))
