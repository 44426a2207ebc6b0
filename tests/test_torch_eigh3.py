"""ops/linalg.eigh3's routes on the CPU: the plain version
(ops/kernels.eigh3_plain) is the Jacobi eigensolver's arithmetic as it was
before K7 (csrc/eigh3.cu) took the card's f32 calls, bit for bit; the
wrapper's shape check, its routing (CPU and f64 inputs never reach K7's
wrapper, which refuses them) and its span. K7 itself is held to the plain version on the card
by tests/test_torch_eigh3_card.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_entries as te
from parsenet_tpu_torch.ops import kernels, linalg


def _eigh3_before(A: torch.Tensor, sweeps: int = 7):
    """ops/linalg.eigh3 as it stood before K7, verbatim."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    V = eye.clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c, s = torch.cos(theta), torch.sin(theta)
            J = eye.clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def _inputs(kind: str, batch: tuple, dtype) -> torch.Tensor:
    rng = np.random.RandomState(len(kind) * 101 + int(np.prod(batch)))
    b = int(np.prod(batch))
    if kind == "spd":
        G = rng.randn(b, 3, 3)
        A = G @ G.transpose(0, 2, 1)
    elif kind == "plane":
        pts = rng.randn(b, 100, 3) * [1.0, 0.5, 1e-3]
        pts -= pts.mean(1, keepdims=True)
        A = pts.transpose(0, 2, 1) @ pts
    elif kind == "zeros":
        A = np.zeros((b, 3, 3))
    elif kind == "repeated":
        A = np.broadcast_to(np.diag([2.0, 2.0, 5.0]), (b, 3, 3)).copy()
    else:   # a NaN row beside an inf row
        G = rng.randn(b, 3, 3)
        A = G @ G.transpose(0, 2, 1)
        A[:, 1] = np.nan
        A[:, 2, 0] = np.inf
    return torch.as_tensor(A.reshape(*batch, 3, 3), dtype=dtype)


def _same(got, want):
    for g, t in zip(got, want):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert torch.equal(g.view(torch.int32 if g.dtype == torch.float32
                                  else torch.int64),
                           t.view(torch.int32 if t.dtype == torch.float32
                                  else torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("batch", [(), (1,), (4,), (50,), (5, 50), (0,)],
                         ids=lambda b: "x".join(map(str, b)) or "one")
@pytest.mark.parametrize("kind", ["spd", "plane", "zeros", "repeated",
                                  "nonfinite"])
def test_cpu_route_is_the_arithmetic_before_k7(kind, batch, dtype):
    A = _inputs(kind, batch, dtype)
    want = _eigh3_before(A)
    _same(linalg.eigh3(A), want)
    _same(kernels.eigh3_plain(A), want)


@pytest.mark.parametrize("sweeps", [0, 1, 3, 12])
def test_cpu_route_at_other_sweeps(sweeps):
    A = _inputs("spd", (12,), torch.float32)
    _same(linalg.eigh3(A, sweeps), _eigh3_before(A, sweeps))


@pytest.mark.parametrize("shape", [(3,), (3, 4), (4, 3), (2, 2), (5, 3, 2),
                                   (4, 4, 4)])
def test_wrapper_rejects_other_shapes(shape):
    with pytest.raises(ValueError, match=r"\[\.\.\., 3, 3\]"):
        linalg.eigh3(torch.zeros(shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cpu_and_f64_never_reach_the_kernel(monkeypatch, dtype):
    def k7(*a, **k):
        raise AssertionError("a CPU input reached K7's wrapper")
    monkeypatch.setattr(kernels, "eigh3", k7)
    A = _inputs("spd", (50,), dtype)
    _same(linalg.eigh3(A), _eigh3_before(A))
    w, U = linalg.safe_eigh(A)
    _same((w, U), _eigh3_before(A))


def test_cpu_route_keeps_autograd_and_kernel_wrapper_refuses_grad():
    """On the CPU linalg.eigh3 is the plain version, differentiable as
    before, in f32 as in f64; K7's wrapper keeps every kernel's rule and
    raises on an input that requires grad under grad mode, on the CPU
    too."""
    for dtype in (torch.float64, torch.float32):
        A = _inputs("spd", (4,), dtype).requires_grad_(True)
        w, _ = linalg.eigh3(A)
        w.sum().backward()
        assert A.grad is not None and bool(torch.isfinite(A.grad).all())
        with pytest.raises(ValueError, match="requires grad"):
            kernels.eigh3(A)


@pytest.mark.parametrize("shape, dtype", [
    ((50, 3, 3), torch.float32), ((3, 3), torch.float32),
    ((50, 3, 3), torch.float64), ((4, 4, 4), torch.float32)],
    ids=["cpu-f32", "cpu-unbatched", "cpu-f64", "cpu-4x4"])
def test_kernel_wrapper_refuses_what_k7_cannot_take(shape, dtype):
    """kernels.eigh3 is K7 alone: linalg.eigh3 owns the routing, so the
    wrapper has no CPU route and refuses a CPU tensor, under no_grad too."""
    with torch.no_grad(), pytest.raises(ValueError, match="K7 takes f32"):
        kernels.eigh3(torch.zeros(shape, dtype=dtype))


def test_one_span_a_call():
    A = _inputs("plane", (50,), torch.float32)

    def run():
        linalg.eigh3(A)
        linalg.smallest_eigvec(A)
    names = [n for n, _, _ in te.profiled(run)]
    assert names.count("linalg.eigh3") == 2
