"""The hand-written CUDA kernels, their wrappers, plain versions and counts.

Counterpart of parsenet_tpu/ops/pallas_kernels.py. Each TPU kernel on the
inference path is a CUDA C++ source for sm_90a under `csrc/`:

  K1 ms_iterations.cu   <- mean_shift_iterations_pallas
  K2 auction_assign.cu  <- auction_assign_pallas
  K3 min_sqdist.cu      <- min_sqdist_with_idx_pallas

`build_kernels` compiles every source with nvcc into a plain-C shared
library under `csrc/build/` (one nvcc per source, all started together; a
library whose source hash is already built is reused) and loads it with
ctypes. A wrapper given CUDA tensors launches its kernel on the current
stream or raises; only CPU tensors go to the plain PyTorch version beside
it. `LAUNCHES` counts kernel launches, one per wrapper call that launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {"K1": "ms_iterations.cu", "K2": "auction_assign.cu",
           "K3": "min_sqdist.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {name: 0 for name in SOURCES}
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "K1": ("ms_iterations", [_P, _P, _P, _I, _I, _I, _P]),
    "K2": ("auction_assign", [_P, _P, _I, _I, _F, _I, _F, _I, _P]),
    "K3": ("min_sqdist_idx", [_P, _P, _P, _P, _P, _I, _I, _P]),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("kernels: no CUDA toolkit found (CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernels() -> float:
    """Compile and load every kernel library; returns the seconds taken.
    A failed build raises with nvcc's output."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        path = _lib_path(name)
        if name in _LIBS or path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        BUILD_LOG[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernels: nvcc failed\n" + "\n".join(failed))
    for name in SOURCES:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn_name, argtypes = _ARGTYPES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return time.perf_counter() - t0


def _launch(name: str, *args) -> None:
    if name not in _LIBS:
        build_kernels()
    fn = getattr(_LIBS[name], _ARGTYPES[name][0])
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"kernels: {SOURCES[name]} launch failed with "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: inputs must all lie on one CUDA device or "
                     f"all on the CPU, got {[t.device for t in tensors]}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


# ---------------------------------------------------------------------------
# K1: mean-shift iterations
# ---------------------------------------------------------------------------

MS_WIDTH = 128  # the kernel's feature width; narrower inputs are zero-padded


def _inv2b2(bandwidth, device) -> torch.Tensor:
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=device)
    return (1.0 / (2.0 * bw * bw)).reshape(1)


def mean_shift_iterations_plain(X: torch.Tensor, bandwidth, iterations: int,
                                bf16_dots: bool = False) -> torch.Tensor:
    """`iterations` gaussian mean-shift steps of every row of X [N, D]:
    m <- normalize((K @ X) / (rowsum K + 1e-12)), K = exp((2 m.X - 2)
    inv2b2). bf16_dots rounds both operands of both products to bf16 and
    accumulates in f32; the row sum takes the f32 K."""
    inv2b2 = _inv2b2(bandwidth, X.device)
    rnd = ((lambda t: t.to(torch.bfloat16).to(torch.float32)) if bf16_dots
           else (lambda t: t))
    xd = rnd(X)
    m = X
    for _ in range(iterations):
        s = rnd(m) @ xd.T
        k = torch.exp((2.0 * s - 2.0) * inv2b2)
        new_m = (rnd(k) @ xd) / (torch.sum(k, dim=1, keepdim=True) + 1e-12)
        m = new_m / (torch.linalg.norm(new_m, dim=1, keepdim=True) + 1e-12)
    return m


def mean_shift_iterations(X: torch.Tensor, bandwidth, iterations: int,
                          bf16_dots: bool = False,
                          tol: float = 0.0) -> torch.Tensor:
    """K1. X: [N, D] f32 unit rows, D <= 128 -> [N, D]. One launch runs all
    iterations. The TPU kernel's tol > 0 early exit is not ported."""
    if tol > 0.0:
        raise ValueError("mean_shift_iterations: tol > 0 is not supported")
    if not _on_cuda("mean_shift_iterations", X):
        return mean_shift_iterations_plain(X, bandwidth, iterations,
                                           bf16_dots)
    _check("mean_shift_iterations", X, torch.float32, 2)
    n, d = X.shape
    if n == 0 or d > MS_WIDTH:
        raise ValueError(f"mean_shift_iterations: kernel takes 1 <= N and "
                         f"D <= {MS_WIDTH}, got {tuple(X.shape)}")
    xp = X if d == MS_WIDTH else torch.nn.functional.pad(
        X, (0, MS_WIDTH - d)).contiguous()
    inv2b2 = _inv2b2(bandwidth, X.device)
    out = torch.empty_like(xp)
    _launch("K1", xp.data_ptr(), out.data_ptr(), inv2b2.data_ptr(), n,
            int(iterations), int(bool(bf16_dots)))
    return out[:, :d]


# ---------------------------------------------------------------------------
# K2: auction assignment
# ---------------------------------------------------------------------------

AUCTION_NEG = -1e9
AUCTION_ROUNDS = 512  # round cap, as the TPU kernel's static trip count
AUCTION_MAX_N = 64    # the kernel's largest padded size


def _pad_benefit(benefit: torch.Tensor) -> torch.Tensor:
    """[B, n, n] -> [B, n_pad, n_pad], n_pad = max(8, ceil8(n)): padding
    entries -1e6, padding persons parked on their own padding object (+1)."""
    b, n, _ = benefit.shape
    n_pad = max(8, -(-n // 8) * 8)
    out = torch.full((b, n_pad, n_pad), -1e6, dtype=torch.float32,
                     device=benefit.device)
    out[:, :n, :n] = benefit
    pad = torch.arange(n, n_pad, device=benefit.device)
    out[:, pad, pad] = -1e6 + 1.0
    return out


def auction_assign_plain(benefit: torch.Tensor, eps0: float, esc_every: int,
                         esc: float, max_iter: int) -> torch.Tensor:
    """The TPU kernel's forward auction in PyTorch ops. benefit [n, n] or
    [B, n, n] -> obj_of_person [n] / [B, n] int32 (-1 on bailout). Stops
    once every person is assigned: later rounds are provable no-ops."""
    squeeze = benefit.dim() == 2
    bp = _pad_benefit(benefit[None] if squeeze else benefit)
    b, n, _ = bp.shape
    dev = bp.device
    neg = torch.tensor(AUCTION_NEG, dtype=torch.float32, device=dev)
    col = torch.arange(n, device=dev)
    obj = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    prices = torch.zeros((b, n), dtype=torch.float32, device=dev)
    eps = torch.tensor(eps0, dtype=torch.float32, device=dev)
    esc_t = torch.tensor(esc, dtype=torch.float32, device=dev)
    for it in range(min(int(max_iter), AUCTION_ROUNDS)):
        unas = obj < 0
        if not bool(unas.any()):
            break
        vals = bp - prices[:, None, :]
        a1 = torch.argmax(vals, dim=2)
        m1 = torch.gather(vals, 2, a1[..., None])[..., 0]
        oh = col[None, None, :] == a1[..., None]
        m2 = torch.amax(torch.where(oh, vals - 2.0 * abs(AUCTION_NEG), vals),
                        dim=2)
        price_a1 = torch.gather(prices, 1, a1)
        bid = torch.where(unas, price_a1 + (m1 - m2) + eps, neg)
        bid_mat = torch.where(oh, bid[..., None], neg)       # [B, person, obj]
        obj_best = torch.amax(bid_mat, dim=1)
        winner = torch.argmax(bid_mat, dim=1)
        got_bid = obj_best > AUCTION_NEG / 2
        own = obj.clamp(min=0)
        evicted = ((obj >= 0) & torch.gather(got_bid, 1, own)
                   & (torch.gather(winner, 1, own) != col[None, :]))
        obj = torch.where(evicted, -1, obj)
        win = unas & (torch.gather(winner, 1, a1) == col[None, :])
        obj = torch.where(win, a1, obj)
        prices = torch.where(got_bid, obj_best, prices)
        if (it + 1) % int(esc_every) == 0:
            eps = eps * esc_t
    out = obj[:, :benefit.shape[-1]].to(torch.int32)
    return out[0] if squeeze else out


def auction_assign(benefit: torch.Tensor, eps0: float, esc_every: int,
                   esc: float, max_iter: int) -> torch.Tensor:
    """K2. Forward auction on prepared benefit matrices [n, n] or [B, n, n]
    (higher = better), one block per matrix, min(max_iter, 512) rounds.
    Returns obj_of_person int32 (-1 where a person is left unassigned)."""
    if not _on_cuda("auction_assign", benefit):
        return auction_assign_plain(benefit, eps0, esc_every, esc, max_iter)
    squeeze = benefit.dim() == 2
    b3 = benefit[None] if squeeze else benefit
    if (b3.dim() != 3 or b3.shape[1] != b3.shape[2]
            or b3.dtype != torch.float32):
        raise ValueError(f"auction_assign: expected f32 [B, n, n], got "
                         f"{tuple(benefit.shape)} {benefit.dtype}")
    bp = _pad_benefit(b3).contiguous()
    bsz, n_pad, _ = bp.shape
    if n_pad > AUCTION_MAX_N or int(esc_every) <= 0:
        raise ValueError(f"auction_assign: kernel takes n_pad <= "
                         f"{AUCTION_MAX_N} and esc_every > 0, got n_pad "
                         f"{n_pad}, esc_every {esc_every}")
    out = torch.empty((bsz, n_pad), dtype=torch.int32, device=bp.device)
    _launch("K2", bp.data_ptr(), out.data_ptr(), bsz, n_pad, float(eps0),
            int(esc_every), float(esc),
            min(int(max_iter), AUCTION_ROUNDS))
    out = out[:, :benefit.shape[-1]]
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# K3: min squared distance with argmin
# ---------------------------------------------------------------------------

MIN_SQDIST_BIG = 1e30  # masked targets (the TPU kernel's constant)
PLAIN_QUERY_CHUNK = 8192  # query rows per [chunk, M] block of the plain version


def _penalty(x: torch.Tensor, x_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if x_mask is None:
        return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    return torch.where(x_mask > 0, 0.0, MIN_SQDIST_BIG).to(torch.float32)


def min_sqdist_with_idx_plain(q: torch.Tensor, x: torch.Tensor,
                              x_mask: Optional[torch.Tensor] = None):
    """Per query of q [N, 3]: (min_j (qq - 2 q.x_j + xx_j) + pen_j, first
    argmin) over x [M, 3]; masked targets get +1e30. -> ([N] f32, [N] int32)."""
    pen = _penalty(x, x_mask)
    xx = torch.sum(x * x, dim=1)
    dists, idxs = [], []
    for s in range(0, q.shape[0], PLAIN_QUERY_CHUNK):
        qc = q[s:s + PLAIN_QUERY_CHUNK]
        qq = torch.sum(qc * qc, dim=1, keepdim=True)
        d = (qq - 2.0 * (qc @ x.T)) + xx[None, :] + pen[None, :]
        i = torch.argmin(d, dim=1)
        dists.append(torch.gather(d, 1, i[:, None])[:, 0])
        idxs.append(i)
    d = torch.clamp(torch.cat(dists), max=MIN_SQDIST_BIG)
    i = torch.clamp(torch.cat(idxs), 0, x.shape[0] - 1).to(torch.int32)
    return d, i


def min_sqdist_with_idx(q: torch.Tensor, x: torch.Tensor,
                        x_mask: Optional[torch.Tensor] = None):
    """K3. q [N, 3], x [M, 3], optional x_mask [M] (> 0 keeps a target) ->
    (min squared distance [N] f32, argmin [N] int32 clipped to [0, M-1])."""
    tensors = (q, x) if x_mask is None else (q, x, x_mask)
    if not _on_cuda("min_sqdist_with_idx", *tensors):
        return min_sqdist_with_idx_plain(q, x, x_mask)
    _check("min_sqdist_with_idx q", q, torch.float32, 2)
    _check("min_sqdist_with_idx x", x, torch.float32, 2)
    if q.shape[1] != 3 or x.shape[1] != 3 or q.shape[0] == 0 or x.shape[0] == 0:
        raise ValueError(f"min_sqdist_with_idx: kernel takes non-empty "
                         f"[N, 3] and [M, 3], got {tuple(q.shape)}, "
                         f"{tuple(x.shape)}")
    if x_mask is not None and x_mask.shape != (x.shape[0],):
        raise ValueError(f"min_sqdist_with_idx: mask {tuple(x_mask.shape)} "
                         f"does not match x {tuple(x.shape)}")
    pen = _penalty(x, x_mask).contiguous()
    out = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    idx = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    _launch("K3", q.data_ptr(), x.data_ptr(), pen.data_ptr(), out.data_ptr(),
            idx.data_ptr(), q.shape[0], x.shape[0])
    return out, idx
