"""The hand-written CUDA kernels, their wrappers, plain versions and counts.

Counterpart of parsenet_tpu/ops/pallas_kernels.py. Each TPU kernel is a
CUDA C++ source for sm_90a under `csrc/`:

  K1 ms_iterations.cu   <- mean_shift_iterations_pallas, f32 (FFMA)
  K1tc ms_iterations_tc.cu <- mean_shift_iterations_pallas, bf16_dots
                          (wgmma; the mode the inference path runs)
  K2 auction_assign.cu  <- auction_assign_pallas
  K3 min_sqdist.cu      <- min_sqdist_with_idx_pallas (batched)
  K4 min_sqdist_bwd.cu  <- the backward of min_sqdist_fused's custom VJP
  K5 ms_iterations.cu   <- mean_shift_step_pallas, a mode of K1's kernel

`build_kernels` compiles every source with nvcc into a plain-C shared
library under `csrc/build/` (one nvcc per source, all started together; a
library whose source hash is already built is reused) and loads it with
ctypes. A wrapper given CUDA tensors launches its kernel on the current
stream or raises; only CPU tensors go to the plain PyTorch version beside
it. `LAUNCHES` counts kernel launches, one per wrapper call that launches.

K1, K2, K5 and the raw K3 have no backward: given an input that requires
grad while grad mode is on they raise, on every device, instead of
returning a result with no `grad_fn`. The differentiable min-sqdist is
`MinSqdist` (K3 forward, K4 backward).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {"K1": "ms_iterations.cu", "K1tc": "ms_iterations_tc.cu",
           "K2": "auction_assign.cu", "K3": "min_sqdist.cu",
           "K4": "min_sqdist_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# kernel -> (library it lives in, C function, argtypes); K5 is K1's kernel
ENTRIES = {
    "K1": ("K1", "ms_iterations", [_P, _P, _P, _I, _I, _P]),
    "K1tc": ("K1tc", "ms_iterations_tc",
             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "K2": ("K2", "auction_assign", [_P, _P, _I, _I, _F, _I, _F, _I, _P]),
    "K3": ("K3", "min_sqdist_idx", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "K4": ("K4", "min_sqdist_bwd", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "K5": ("K1", "ms_step", [_P, _P, _P, _P, _I, _I, _P]),
}

LAUNCHES = {name: 0 for name in ENTRIES}
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


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
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    for lib, fn_name, argtypes in ENTRIES.values():
        fn = getattr(_LIBS[lib], fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return time.perf_counter() - t0


def _launch(name: str, *args) -> None:
    lib, fn_name, _ = ENTRIES[name]
    if lib not in _LIBS:
        build_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(_LIBS[lib], fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"kernels: {SOURCES[lib]}:{fn_name} launch failed "
                           f"with cudaError {rc}")
    LAUNCHES[name] += 1


def _on_cuda(name: str, *tensors: torch.Tensor, scalars=()) -> bool:
    """The dispatch rule of every wrapper: True for CUDA inputs, False for
    CPU inputs; mixed or other devices raise. So does, on any device, an
    input (or a tensor among `scalars`) that requires grad while grad mode
    is on: the kernels have no backward of their own."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (*tensors, *scalars)):
        raise ValueError(f"{name}: an input requires grad, but this kernel "
                         "has no backward; call it under torch.no_grad() or "
                         "use kernels.MinSqdist for a differentiable "
                         "min-sqdist")
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


MS_TILE = 64          # rows of one bf16 tile of X, and of one warpgroup's m
MS_BLOCK_ROWS = 128   # rows of m per block of the tensor-core kernel
_MS_TILE_ORDER: dict[str, torch.Tensor] = {}  # device -> tile gather index
MS_PART_FLOATS = 2 * (MS_TILE * MS_WIDTH + 2 * 128)  # one block's partial


@functools.lru_cache(maxsize=None)
def ms_plan(n: int, sms: int) -> tuple[int, int]:
    """How the tensor-core K1 spreads N rows over a card with `sms` SMs:
    (grid, slots). An iteration is blocks x tiles units of work (a 128-row
    block of m against a 64-row tile of X, blocks = ceil(N / 128), tiles =
    ceil(N / 64)); grid block g takes units [floor(g U / grid),
    floor((g + 1) U / grid)) in row-block-major order, as the kernel
    computes them. With fewer row blocks than SMs, grid = min(sms, U): every
    SM works, at most two row blocks per grid block, and the grid blocks
    sharing a row block add their partial sums through the workspace; slots
    is the most that share one. Otherwise one grid block per row block
    (grid = blocks, slots = 1, no exchange)."""
    blocks = -(-n // MS_BLOCK_ROWS)
    tiles = -(-n // MS_TILE)
    units = blocks * tiles
    if blocks >= sms:
        return blocks, 1
    grid = min(sms, units)

    def owner(u):   # the largest g with floor(g U / grid) <= u
        return ((u + 1) * grid - 1) // units

    slots = max(owner(b * tiles + tiles - 1) - owner(b * tiles) + 1
                for b in range(blocks))
    return grid, slots


def ms_tiles_bf16(X: torch.Tensor) -> torch.Tensor:
    """The tensor-core K1's operand: X [N, D <= 128] in bf16, zero-padded to
    [ceil(N / 128) * 128, 128] and cut into 64-row tiles, flat. A tile is
    two 64-column halves, each 64 rows of 128 bytes in wgmma's 128-byte
    swizzle: the 16-byte chunk j (columns 8j..8j+7) of row r is stored at
    chunk j ^ (r % 8). So element (R, C) lies at bf16 offset
    8192 (R // 64) + 4096 (C // 64) + 64 (R % 64)
    + 8 (((C % 64) // 8) ^ (R % 8)) + C % 8."""
    n, d = X.shape
    n_pad = -(-n // MS_BLOCK_ROWS) * MS_BLOCK_ROWS
    xb = torch.zeros((n_pad, MS_WIDTH), dtype=torch.bfloat16, device=X.device)
    xb[:n, :d] = X
    return xb.view(-1, MS_TILE * MS_WIDTH)[:, _tile_order(X.device)].reshape(-1)


def _tile_order(device: torch.device) -> torch.Tensor:
    """For each position of a swizzled tile, the row-major index (64 x 128)
    of the element stored there; cached per device."""
    key = str(device)
    if key not in _MS_TILE_ORDER:
        half, row, chunk, elem = torch.meshgrid(
            torch.arange(2), torch.arange(MS_TILE), torch.arange(8),
            torch.arange(8), indexing="ij")
        src = row * MS_WIDTH + half * 64 + (chunk ^ (row % 8)) * 8 + elem
        _MS_TILE_ORDER[key] = src.reshape(-1).to(device)
    return _MS_TILE_ORDER[key]


def mean_shift_iterations(X: torch.Tensor, bandwidth, iterations: int,
                          bf16_dots: bool = False,
                          tol: float = 0.0) -> torch.Tensor:
    """K1. X: [N, D] f32 unit rows, D <= 128 -> [N, D]. One launch runs all
    iterations: bf16_dots on the tensor-core kernel (ms_iterations_tc.cu),
    f32 on the FFMA kernel (ms_iterations.cu). No iteration returns a copy
    of X, as the plain version does, and launches nothing. The TPU kernel's
    tol > 0 early exit is not ported."""
    if tol > 0.0:
        raise ValueError("mean_shift_iterations: tol > 0 is not supported")
    if not _on_cuda("mean_shift_iterations", X, scalars=(bandwidth,)):
        return mean_shift_iterations_plain(X, bandwidth, iterations,
                                           bf16_dots)
    _check("mean_shift_iterations", X, torch.float32, 2)
    n, d = X.shape
    if n == 0 or d > MS_WIDTH:
        raise ValueError(f"mean_shift_iterations: kernel takes 1 <= N and "
                         f"D <= {MS_WIDTH}, got {tuple(X.shape)}")
    if iterations < 1:
        return X.clone()
    inv2b2 = _inv2b2(bandwidth, X.device)
    if bf16_dots:
        sms = torch.cuda.get_device_properties(X.device).multi_processor_count
        return _ms_iterations_tc(X, inv2b2, int(iterations),
                                 ms_plan(n, sms)[0])[:, :d]
    xp = X if d == MS_WIDTH else torch.nn.functional.pad(
        X, (0, MS_WIDTH - d)).contiguous()
    out = torch.empty_like(xp)
    _launch("K1", xp.data_ptr(), out.data_ptr(), inv2b2.data_ptr(), n,
            int(iterations))
    return out[:, :d]


def _ms_iterations_tc(X: torch.Tensor, inv2b2: torch.Tensor, iterations: int,
                      grid: int) -> torch.Tensor:
    """One launch of the tensor-core K1 on CUDA X [N, D <= 128] f32 over
    `grid` blocks (ms_plan's, or ceil(N / 128) for no exchange) -> [N, 128]
    f32 (D zero-padded)."""
    n = X.shape[0]
    blocks = -(-n // MS_BLOCK_ROWS)
    slots = 1 if grid == blocks else ms_plan(n, grid)[1]
    out = torch.empty((n, MS_WIDTH), dtype=torch.float32, device=X.device)
    ws = torch.empty((2 * blocks * slots * MS_PART_FLOATS if grid > blocks
                      else 1,), dtype=torch.float32, device=X.device)
    counters = torch.zeros((blocks,), dtype=torch.int32, device=X.device)
    _launch("K1tc", ms_tiles_bf16(X).data_ptr(), out.data_ptr(),
            inv2b2.data_ptr(), ws.data_ptr(), counters.data_ptr(), n,
            iterations, grid, slots)
    return out


def mean_shift_step_plain(m: torch.Tensor, x: torch.Tensor,
                          inv2b2) -> torch.Tensor:
    """One f32 mean-shift step of the queries m [Nq, D] against the keys x
    [Nk, D]: normalize((K @ x) / (rowsum K + 1e-12)), K = exp((2 m.x - 2)
    inv2b2) over all Nk keys."""
    s = m @ x.T
    k = torch.exp((2.0 * s - 2.0) * inv2b2)
    new_m = (k @ x) / (torch.sum(k, dim=1, keepdim=True) + 1e-12)
    return new_m / (torch.linalg.norm(new_m, dim=1, keepdim=True) + 1e-12)


def mean_shift_step(m: torch.Tensor, x: torch.Tensor,
                    inv2b2) -> torch.Tensor:
    """K5, the one-step mode of K1's kernel. m [Nq, D], x [Nk, D] f32,
    D <= 128, inv2b2 = 1 / (2 b^2) -> [Nq, D]. The key columns are masked
    by Nk; the TPU kernel masks them by Nq, which agrees at m = x, its only
    use."""
    if not _on_cuda("mean_shift_step", m, x, scalars=(inv2b2,)):
        return mean_shift_step_plain(m, x, inv2b2)
    _check("mean_shift_step m", m, torch.float32, 2)
    _check("mean_shift_step x", x, torch.float32, 2)
    (nq, d), nk = m.shape, x.shape[0]
    if nq == 0 or nk == 0 or d > MS_WIDTH or x.shape[1] != d:
        raise ValueError(f"mean_shift_step: kernel takes non-empty [Nq, D] "
                         f"and [Nk, D], D <= {MS_WIDTH}, got "
                         f"{tuple(m.shape)}, {tuple(x.shape)}")
    pad = (lambda t: t if d == MS_WIDTH else torch.nn.functional.pad(
        t, (0, MS_WIDTH - d)).contiguous())
    mp, xp = pad(m), pad(x)
    inv = torch.as_tensor(inv2b2, dtype=torch.float32,
                          device=m.device).reshape(1).contiguous()
    out = torch.empty_like(mp)
    _launch("K5", mp.data_ptr(), xp.data_ptr(), out.data_ptr(),
            inv.data_ptr(), nq, nk)
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
        return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    return torch.where(x_mask > 0, 0.0, MIN_SQDIST_BIG).to(torch.float32)


def _as_batch(q, x, x_mask):
    """2-d inputs -> a batch of one: (q3, x3, mask3, squeeze)."""
    if q.dim() == 2:
        return (q[None], x[None], None if x_mask is None else x_mask[None],
                True)
    return q, x, x_mask, False


def min_sqdist_with_idx_plain(q: torch.Tensor, x: torch.Tensor,
                              x_mask: Optional[torch.Tensor] = None):
    """Per query of q [N, 3] (or [B, N, 3]): (min_j (qq - 2 q.x_j + xx_j) +
    pen_j, first argmin) over x [M, 3] (or patch b's x [B, M, 3]); masked
    targets get +1e30. -> ([N] f32, [N] int32), or [B, N] each."""
    q, x, x_mask, squeeze = _as_batch(q, x, x_mask)
    pen = _penalty(x, x_mask)                                 # [B, M]
    xx = torch.sum(x * x, dim=2)
    xt = x.transpose(1, 2)
    dists, idxs = [], []
    for s in range(0, q.shape[1], PLAIN_QUERY_CHUNK):
        qc = q[:, s:s + PLAIN_QUERY_CHUNK]
        qq = torch.sum(qc * qc, dim=2, keepdim=True)
        d = (qq - 2.0 * (qc @ xt)) + xx[:, None, :] + pen[:, None, :]
        i = torch.argmin(d, dim=2)
        dists.append(torch.gather(d, 2, i[..., None])[..., 0])
        idxs.append(i)
    d = torch.clamp(torch.cat(dists, 1), max=MIN_SQDIST_BIG)
    i = torch.clamp(torch.cat(idxs, 1), 0, x.shape[1] - 1).to(torch.int32)
    return (d[0], i[0]) if squeeze else (d, i)


def min_sqdist_with_idx(q: torch.Tensor, x: torch.Tensor,
                        x_mask: Optional[torch.Tensor] = None):
    """K3. q [N, 3], x [M, 3], optional x_mask [M] (> 0 keeps a target) ->
    (min squared distance [N] f32, argmin [N] int32 clipped to [0, M-1]).
    Batched: q [B, N, 3], x [B, M, 3], x_mask [B, M] -> [B, N] each, one
    launch. No backward: see `MinSqdist`."""
    tensors = (q, x) if x_mask is None else (q, x, x_mask)
    if not _on_cuda("min_sqdist_with_idx", *tensors):
        return min_sqdist_with_idx_plain(q, x, x_mask)
    q3, x3, mask3, squeeze = _as_batch(q, x, x_mask)
    _check("min_sqdist_with_idx q", q3, torch.float32, 3)
    _check("min_sqdist_with_idx x", x3, torch.float32, 3)
    (b, n, c), (bx, m, cx) = q3.shape, x3.shape
    if c != 3 or cx != 3 or b != bx or min(b, n, m) == 0:
        raise ValueError(f"min_sqdist_with_idx: kernel takes non-empty "
                         f"[B, N, 3] and [B, M, 3], got {tuple(q.shape)}, "
                         f"{tuple(x.shape)}")
    if mask3 is not None and mask3.shape != (b, m):
        raise ValueError(f"min_sqdist_with_idx: mask {tuple(x_mask.shape)} "
                         f"does not match x {tuple(x.shape)}")
    pen = _penalty(x3, mask3).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    _launch("K3", q3.data_ptr(), x3.data_ptr(), pen.data_ptr(),
            out.data_ptr(), idx.data_ptr(), b, n, m)
    return (out[0], idx[0]) if squeeze else (out, idx)


# ---------------------------------------------------------------------------
# K4: backward of the differentiable min squared distance
# ---------------------------------------------------------------------------

def min_sqdist_bwd_plain(q: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                         g: torch.Tensor):
    """dq = 2 (q - x[idx]) g, dx = scatter-add of -dq at idx (gather +
    index_add_). q [B, N, 3], x [B, M, 3], idx, g [B, N] -> (dq, dx)."""
    b, m = x.shape[0], x.shape[1]
    rows = (idx.long() + m * torch.arange(b, device=x.device)[:, None])
    xa = x.reshape(b * m, 3)[rows.reshape(-1)].reshape(q.shape)
    dq = 2.0 * (q - xa) * g[..., None]
    dx = torch.zeros((b * m, 3), dtype=x.dtype, device=x.device)
    dx.index_add_(0, rows.reshape(-1), -dq.reshape(-1, 3))
    return dq, dx.reshape(x.shape)


def min_sqdist_bwd(q: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                   g: torch.Tensor):
    """K4. The backward of `MinSqdist` for q [B, N, 3], x [B, M, 3], the
    forward's argmin idx [B, N] int32 and the incoming gradient g [B, N] f32
    -> (dq [B, N, 3], dx [B, M, 3]). dx sums with float atomics on the
    card, so its last bits depend on the order of the adds."""
    if not _on_cuda("min_sqdist_bwd", q, x, idx, g):
        return min_sqdist_bwd_plain(q, x, idx, g)
    for label, t, dtype, ndim in (("q", q, torch.float32, 3),
                                  ("x", x, torch.float32, 3),
                                  ("idx", idx, torch.int32, 2),
                                  ("g", g, torch.float32, 2)):
        _check(f"min_sqdist_bwd {label}", t, dtype, ndim)
    (b, n, _), m = q.shape, x.shape[1]
    if x.shape != (b, m, 3) or q.shape[2] != 3 or idx.shape != (b, n) \
            or g.shape != (b, n) or min(b, n, m) == 0:
        raise ValueError(f"min_sqdist_bwd: shapes q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}, idx {tuple(idx.shape)}, g "
                         f"{tuple(g.shape)}")
    dq = torch.empty_like(q)
    dx = torch.empty_like(x)
    _launch("K4", q.data_ptr(), x.data_ptr(), idx.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dx.data_ptr(), b, n, m)
    return dq, dx


class MinSqdist(torch.autograd.Function):
    """Differentiable min squared distance, min_sqdist_fused's counterpart:
    the forward is K3 (saving q, x and the argmin), the backward K4, the
    subgradient through the argmin. q [B, N, 3], x [B, M, 3], optional
    x_mask [B, M] (not differentiated) -> [B, N]."""

    @staticmethod
    def forward(ctx, q, x, x_mask=None):
        d, idx = min_sqdist_with_idx(q, x, x_mask)
        ctx.save_for_backward(q, x, idx)
        return d

    @staticmethod
    def backward(ctx, g):
        q, x, idx = ctx.saved_tensors
        dq, dx = min_sqdist_bwd(q, x, idx, g.contiguous())
        return (dq if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None, None)
