"""On the card: K7 (csrc/eigh3.cu, the batched symmetric 3x3 Jacobi
eigensolver) held to the plain version (ops/kernels.eigh3_plain: the
rotations as torch.bmm, atan2, cos and sin on the card) bit for bit in
the eigenvalues and the eigenvectors, on every class of input the fits and
the slots' standardisation build and at every batch shape they use, and on
the very matrices that the protocol's and the e2e trainer's pool shapes
build. Imports no JAX: on the card run

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_eigh3_card.py
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pools' seeds (benchmark/mixes): protocol-10k-b4, train-e2e-5x8k
PROTOCOL_SEED, E2E_SEED = 1001, 1004
SHAPES = ([0], [1], [4], [12], [50], [5, 50], [100000])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("runs the CUDA kernels: needs a CUDA card")
    from parsenet_tpu_torch.ops import kernels
    kernels.build_kernels()
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _held(A: torch.Tensor, sweeps: int = 7) -> None:
    """K7 on A against the plain version on the card: w and V bit for bit
    (a NaN's bits included), one launch (none for an empty batch)."""
    from parsenet_tpu_torch.ops import kernels
    kernels.reset_launches()
    w, V = kernels.eigh3(A, sweeps)
    batch = A.numel() // 9
    assert kernels.LAUNCHES["K7"] == (1 if batch else 0)
    wp, Vp = kernels.eigh3_plain(A, sweeps)
    assert w.shape == wp.shape and V.shape == Vp.shape
    bad = ((_bits(w) != _bits(wp)).any(-1)
           | (_bits(V) != _bits(Vp)).flatten(-2).any(-1))
    assert not bool(bad.any()), (
        f"{tuple(A.shape)}: {int(bad.sum())} of {batch} matrices differ from "
        f"the plain version, max |dw| "
        f"{float((w - wp).abs().nan_to_num().max()) if batch else 0.0}")


def _rotations(g, b):
    q, _ = torch.linalg.qr(torch.randn(b, 3, 3, generator=g,
                                       dtype=torch.float64))
    return q.float()


def _covariances(g, b, scales):
    """Mean-centred sample covariances X^T X of 200 points a matrix, spread
    by `scales` along the axes of a random rotation."""
    pts = torch.randn(b, 200, 3, generator=g) * torch.tensor(scales)
    pts = pts @ _rotations(g, b).transpose(-1, -2)
    pts = pts - pts.mean(1, keepdim=True)
    return pts.transpose(-1, -2) @ pts


def _inputs(kind: str, b: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(1000 * KINDS.index(kind) + b)
    d = torch.rand(b, 3, generator=g) * 10
    if kind == "spd":
        G = torch.randn(b, 3, 3, generator=g)
        return G @ G.transpose(-1, -2)
    if kind == "plane":        # a fitted plane's scatter: one thin axis
        return _covariances(g, b, [1.0, 0.5, 1e-3])
    if kind == "normals":      # a cylinder's or cone's normals: one direction
        n = (torch.tensor([0.3, 0.5, 0.8])
             + 0.05 * torch.randn(b, 200, 3, generator=g))
        n = n / n.norm(dim=-1, keepdim=True)
        return n.transpose(-1, -2) @ n
    if kind == "zeros":        # the fits' padded segments
        return torch.zeros(b, 3, 3)
    if kind == "isotropic":
        return d[:, :1, None] * torch.eye(3)
    if kind == "repeated":
        d[:, 1] = d[:, 0]
        R = _rotations(g, b)
        return R @ torch.diag_embed(d) @ R.transpose(-1, -2)
    if kind == "diagonal":
        return torch.diag_embed(d)
    if kind in ("nan_row", "inf_row"):
        A = _inputs("spd", b).clone()
        A[:, 1 if kind == "nan_row" else 2, :] = (
            float("nan") if kind == "nan_row" else float("inf"))
        return A
    raise ValueError(kind)


KINDS = ("spd", "plane", "normals", "zeros", "isotropic", "repeated",
         "diagonal", "nan_row", "inf_row")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_k7_matches_the_plain_version(card, kind, shape):
    b = int(np.prod(shape))
    _held(_inputs(kind, b).reshape(*shape, 3, 3).to(card))


def test_k7_unbatched_and_other_sweeps(card):
    """A single [3, 3] matrix, and 0, 1 and 12 sweeps."""
    A = _inputs("spd", 12).to(card)
    _held(A[0])
    for sweeps in (0, 1, 12):
        _held(A, sweeps)


def _pool(seed, count, n):
    from parsenet_tpu_torch.data.abc import normalize_points
    from parsenet_tpu_torch.data.synthetic import make_shape
    rng = np.random.RandomState(seed)
    pts, nrm, lab, prim = [], [], [], []
    for _ in range(count):
        p, l, q, t = make_shape(rng, n)
        p, q, _, _ = normalize_points(p, q)
        pts.append(p), nrm.append(q), lab.append(l), prim.append(t)
    return (np.stack(pts).astype(np.float32), np.stack(lab),
            np.stack(nrm).astype(np.float32), np.stack(prim))


def _recorded(run) -> list:
    """The inputs of every K7 call that `run` makes."""
    from parsenet_tpu_torch.ops import kernels
    seen, orig = [], kernels.eigh3

    def record(A, sweeps=7):
        seen.append((A.detach().clone(), sweeps))
        return orig(A, sweeps)
    kernels.eigh3 = record
    try:
        run()
    finally:
        kernels.eigh3 = orig
    return seen


def test_k7_on_the_protocols_matrices(card):
    """batch_metrics on 4 shapes of the protocol's pool: the fits' and the
    12 slots' matrices."""
    from parsenet_tpu_torch.eval import pipeline
    from parsenet_tpu_torch.fitting.spline_apply import build_spline_fit
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    pts, labels, normals, prim = _pool(PROTOCOL_SEED, 4, 10000)
    net = load_primitives_embedding(
        os.path.join(REPO, "params", "parsenet_e2e.npz"), mode=5,
        device=card)
    fit = build_spline_fit(device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    seen = _recorded(lambda: pipeline.batch_metrics(
        net, pts, normals, labels, prim, gen, ms_bf16=True, spline_fit=fit,
        device=card))
    assert len(seen) >= 5
    for A, sweeps in seen:
        _held(A, sweeps)


def test_k7_on_the_e2e_trainers_matrices(card):
    """One e2e training step of 2 micro-batches of the e2e pool's shapes at
    8,000 points: the fits' and the 4 slots' matrices."""
    from parsenet_tpu_torch.fitting.spline_apply import build_spline_fit
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding
    from parsenet_tpu_torch.train import state, train_e2e
    pts, labels, normals, prim = _pool(E2E_SEED, 2, 10000)
    keep = np.sort(np.random.RandomState(0).permutation(10000)[:8000])
    x = torch.as_tensor(np.concatenate([pts, normals], -1)[:, None, keep],
                        device=card)
    lab = torch.as_tensor(labels[:, None, keep], device=card).long()
    pr = torch.as_tensor(prim[:, None, keep], device=card).long()
    model = load_primitives_embedding(
        os.path.join(REPO, "params", "parsenet_e2e.npz"), mode=5,
        device=card).train()
    opt = state.make_optimizer(model.parameters(), "adam", 1e-4)
    step, _ = train_e2e.make_e2e_step(model, build_spline_fit(device=card),
                                      opt, ms_num_samples=2048)
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    draws = [train_e2e.draw_e2e(1, 8000, 2048, gen, card) for _ in range(2)]
    seen = _recorded(lambda: step(x, lab, pr, draws, 1e-4))
    assert len(seen) >= 2
    for A, sweeps in seen:
        _held(A, sweeps)


def test_k7_makes_no_host_sync(card):
    from parsenet_tpu_torch.ops import linalg
    A = _inputs("plane", 50).to(card)
    linalg.eigh3(A)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, V = linalg.eigh3(A)
        w, V = linalg.safe_eigh(A)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_k7_routing_and_grad_rules(card):
    """linalg.eigh3 launches K7 for CUDA f32 only; K7 raises on an input
    that requires grad under grad mode; safe_eigh's forward is K7's and
    its backward unchanged (the plain forward's gradient, bit for bit)."""
    from parsenet_tpu_torch.ops import kernels, linalg
    A = _inputs("spd", 50).to(card)
    kernels.reset_launches()
    linalg.eigh3(A.double())
    assert kernels.LAUNCHES["K7"] == 0
    linalg.eigh3(A)
    assert kernels.LAUNCHES["K7"] == 1
    with pytest.raises(ValueError, match="requires grad"):
        kernels.eigh3(A.clone().requires_grad_(True))
    Ag = A.clone().requires_grad_(True)
    w, U = linalg.safe_eigh(Ag)
    assert kernels.LAUNCHES["K7"] == 2
    (w.sum() + U[..., 0].sum()).backward()
    wp, Up = kernels.eigh3_plain(A)
    assert torch.equal(_bits(w.detach()), _bits(wp))
    assert torch.equal(_bits(U.detach()), _bits(Up))
    gw, gU = torch.ones_like(wp), torch.zeros_like(Up)
    gU[..., 0] = 1.0
    ctx = type("Ctx", (), {"saved_tensors": (wp, Up)})()
    assert torch.equal(_bits(Ag.grad),
                       _bits(linalg.SafeEigh.backward(ctx, gw, gU)))
