"""Numerical guards, the fp32 precision policy and the device rule.

Counterpart of parsenet_tpu/core/guards.py. `highest_precision` there wraps
the geometry in full-f32 matmul precision; here one policy, set by every
entry point through `entry_device`, turns TF32 off for matmuls and
convolutions and pins the float32 matmul precision to "highest".
"""
from __future__ import annotations

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


# The policy every entry applies: False is true fp32 (the configurations'
# precision); the benchmark's lower-precision control sets True
# (reference.precision).
TF32 = {"on": False}


def set_fp32_policy() -> None:
    """True fp32 for every matmul and convolution (no TF32 anywhere), or
    TF32 throughout where TF32["on"]."""
    on = TF32["on"]
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def entry_device(device=None) -> torch.device:
    """Resolve an entry point's `device` argument and apply the fp32 policy.

    None means "cuda". A CUDA device that is not present raises: the port
    never carries on silently on the CPU. The CPU is used only when the
    caller asks for it (the tests pass device="cpu").
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "reference: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch versions")
    set_fp32_policy()
    return dev


def guard_exp(x: torch.Tensor, max_value: float = 75.0,
              min_value: float = -75.0) -> torch.Tensor:
    """exp with its input clamped to avoid overflow."""
    return torch.exp(torch.clamp(x, min_value, max_value))


def guard_sqrt(x: torch.Tensor, minimum: float = 1e-5) -> torch.Tensor:
    """sqrt with its input clamped away from 0 (finite gradient)."""
    return torch.sqrt(torch.clamp(x, min=minimum))


def safe_acos(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """acos with its argument pulled off +-1, where its derivative blows
    up (reference: src/primitive_forward.py:836-839)."""
    return torch.arccos(torch.clamp(x, -1.0 + eps, 1.0 - eps))


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-8) -> torch.Tensor:
    """x over its L2 norm along `dim`, guarding the zero vector."""
    return x / (torch.linalg.norm(x, dim=dim, keepdim=True) + eps)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                eps: float = 1e-8) -> torch.Tensor:
    """Mean of `x` over the entries where `mask` is nonzero (over all of
    them where dim is None)."""
    mask = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * mask) / (torch.sum(mask) + eps)
    return torch.sum(x * mask, dim=dim) / (torch.sum(mask, dim=dim) + eps)
