"""3x3 linear algebra for the fitting stack.

Counterpart of parsenet_tpu/ops/linalg.py: the branch-free cyclic-Jacobi
eigendecomposition of symmetric 3x3 matrices (K7 on the card), `safe_eigh`
(that forward with the eigengap-clamped backward of the JAX package's
custom VJP), the smallest eigenvector with its sign rule, and the
ridge-regularised normal-equation least squares.
"""
from __future__ import annotations

import torch

from ..core.profiling import trace
from . import kernels

_GAP_EPS = 1e-4  # the smallest eigengap the backward divides by


def eigh3(A: torch.Tensor, sweeps: int = 7):
    """Symmetric [..., 3, 3] -> (eigenvalues ascending [..., 3],
    eigenvectors as columns [..., 3, 3]) by fixed cyclic Jacobi sweeps:
    K7 for a CUDA f32 input (`kernels.eigh3`, one launch), the plain
    version (`kernels.eigh3_plain`) for every other. One `linalg.eigh3`
    span a call."""
    if A.shape[-2:] != (3, 3):
        raise ValueError(f"eigh3: expected [..., 3, 3], got "
                         f"{tuple(A.shape)}")
    with trace("linalg.eigh3"):
        if A.device.type == "cuda" and A.dtype == torch.float32:
            return kernels.eigh3(A, sweeps)
        return kernels.eigh3_plain(A, sweeps)


class SafeEigh(torch.autograd.Function):
    """eigh3 with the eigengap-clamped backward (reference
    src/fitting_utils.py:385-455, eq. 13 of Ionescu et al.): with F_ij =
    sign(w_j - w_i) / max(|w_j - w_i|, 1e-4) off the diagonal,
    dA = sym(U (F * U^T dU + diag(dw)) U^T). Autograd through the Jacobi
    rotations would give other gradients, and NaN at equal eigenvalues."""

    @staticmethod
    def forward(ctx, A):
        w, U = eigh3(A)
        ctx.save_for_backward(w, U)
        return w, U

    @staticmethod
    def backward(ctx, gw, gU):
        w, U = ctx.saved_tensors
        if gw is None:
            gw = torch.zeros_like(w)
        if gU is None:
            gU = torch.zeros_like(U)
        d = w[..., None, :] - w[..., :, None]          # d[i, j] = w_j - w_i
        sign = torch.where(d >= 0, 1.0, -1.0)
        eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
        F = sign / torch.clamp(torch.abs(d), min=_GAP_EPS) * (1.0 - eye)
        Ut = U.transpose(-1, -2)
        mid = F * (Ut @ gU) + eye * gw[..., None, :]
        dA = U @ (mid @ Ut)
        return 0.5 * (dA + dA.transpose(-1, -2))


def safe_eigh(A: torch.Tensor):
    """(eigenvalues ascending, eigenvectors as columns) of symmetric
    [..., 3, 3], differentiable with eigengap-clamped gradients."""
    return SafeEigh.apply(A)


def smallest_eigvec(M: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric M [..., 3, 3],
    signed so that its largest-magnitude component is positive."""
    _, U = safe_eigh(M)
    v = U[..., :, 0]
    pick = torch.argmax(torch.abs(v), dim=-1, keepdim=True)
    s = torch.sign(torch.gather(v, -1, pick))
    return v * torch.where(s == 0, 1.0, s)


def ridge_lstsq(A: torch.Tensor, y: torch.Tensor,
                lam: float = 0.01) -> torch.Tensor:
    """min ||A x - y||^2 + lam' ||x||^2 by the normal equations, with the
    scale-invariant ridge lam' = lam * trace(A^T A) / n + 1e-10.
    A: [..., m, n], y: [..., m, k] -> x: [..., n, k]."""
    At = A.transpose(-1, -2)
    AtA = At @ A
    n = AtA.shape[-1]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    eye = torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    AtA = AtA + (lam * tr + 1e-10) * eye
    aty = At @ y
    with trace("sync.fits_solve"):   # the card's solve checks its info
        return torch.linalg.solve(AtA, aty)
