"""The hand-written CUDA kernels, their wrappers, plain versions and counts.

Counterpart of parsenet_tpu/ops/pallas_kernels.py. Each TPU kernel is a
CUDA C++ source for sm_90a under `csrc/`:

  K1 ms_iterations_tf32.cu <- mean_shift_iterations_pallas, f32 dots
                          (wgmma in 3xTF32; the library's default mode)
  K1tc ms_iterations_tc.cu <- mean_shift_iterations_pallas, bf16_dots
                          (wgmma; the mode the inference bench runs)
  K1_exit, K1tc_exit      <- the same with tol > 0 (early_exit=True):
                          ms_exit.cuh's kernel on each source's pipeline
  K2 auction_assign.cu  <- auction_assign_pallas with solve_lap's benefit
                          and completion around it (lap_assign: cost ->
                          permutation, one launch for B matrices)
  K2_benefit            <- auction_assign_pallas alone (auction_assign, on
                          a prepared benefit): the same kernel's other entry
  K3 min_sqdist.cu      <- min_sqdist_with_idx_pallas (batched)
  K4 min_sqdist_bwd.cu  <- the backward of min_sqdist_fused's custom VJP
  K5 ms_iterations_tf32.cu <- mean_shift_step_pallas, K1 f32's kernel
                          for one iteration with separate queries

`build_kernels` compiles every source with nvcc into a plain-C shared
library under `csrc/build/` (one nvcc per source, all started together; a
library whose source hash is already built is reused) and loads it with
ctypes. A wrapper given CUDA tensors launches its kernel on the current
stream or raises; only CPU tensors go to the plain PyTorch version beside
it. `LAUNCHES` counts kernel launches, one per wrapper call that launches
(K3's entry adds its merge pass, when its plan splits the targets, as part
of the same launch).

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
SOURCES = {"K1": "ms_iterations_tf32.cu", "K1tc": "ms_iterations_tc.cu",
           "K2": "auction_assign.cu", "K3": "min_sqdist.cu",
           "K4": "min_sqdist_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# kernel -> (library it lives in, C function, argtypes); K5 is K1's kernel
ENTRIES = {
    "K1": ("K1", "ms_iterations_tf32",
           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "K1tc": ("K1tc", "ms_iterations_tc",
             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "K1_exit": ("K1", "ms_iterations_tf32_exit",
                [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]),
    "K1tc_exit": ("K1tc", "ms_iterations_tc_exit",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]),
    "K2": ("K2", "lap_assign",
           [_P, _P, _I, _I, _F, _I, _F, _I, _F, _F, _F, _P]),
    "K2_benefit": ("K2", "auction_assign",
                   [_P, _P, _I, _I, _F, _I, _F, _I, _P]),
    "K3": ("K3", "min_sqdist_idx",
           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "K4": ("K4", "min_sqdist_bwd",
           [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "K5": ("K1", "ms_iterations_tf32",
           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}

LAUNCHES = {name: 0 for name in ENTRIES}
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}  # kernel -> its bound C function


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib_path(name: str) -> Path:
    """The library of SOURCES[name], named by a digest of its source, the
    headers of csrc/ and the flags."""
    src = CSRC / SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
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
    for name, (lib, fn_name, argtypes) in ENTRIES.items():
        fn = getattr(_LIBS[lib], fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return time.perf_counter() - t0


def _launch(name: str, *args) -> None:
    if name not in _FNS:
        build_kernels()
    rc = _FNS[name](*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        lib, fn_name, _ = ENTRIES[name]
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
MS_BLOCK_ROWS = 128   # rows of m per block of both tensor-core kernels


def _inv2b2(bandwidth, device) -> torch.Tensor:
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=device)
    return (1.0 / (2.0 * bw * bw)).reshape(1)


def mean_shift_iterations_plain(X: torch.Tensor, bandwidth, iterations: int,
                                bf16_dots: bool = False, tol: float = 0.0,
                                exit_rows: int = 256) -> torch.Tensor:
    """`iterations` gaussian mean-shift steps of every row of X [N, D]:
    m <- normalize((K @ X) / (rowsum K + 1e-12)), K = exp((2 m.X - 2)
    inv2b2). bf16_dots rounds both operands of both products to bf16 and
    accumulates in f32; the row sum takes the f32 K. tol > 0: each group
    of `exit_rows` rows stops once an iteration moves none of its rows by
    more than tol, the TPU kernel's early exit (its 256-row tile; the CUDA
    kernels' group is their 128-row block)."""
    return _ms_plain(X, bandwidth, iterations, bf16_dots, tol, exit_rows)[0]


def mean_shift_exit_counts(X: torch.Tensor, bandwidth, iterations: int,
                           bf16_dots: bool = False, tol: float = 0.0,
                           exit_rows: int = MS_BLOCK_ROWS) -> torch.Tensor:
    """The iterations each group of `exit_rows` rows runs in
    mean_shift_iterations_plain(..., tol, exit_rows): [ceil(N / exit_rows)]
    int64 (all `iterations` at tol = 0). What a K1 exit call works."""
    return _ms_plain(X, bandwidth, iterations, bf16_dots, tol, exit_rows)[1]


def _ms_plain(X, bandwidth, iterations, bf16_dots, tol, exit_rows):
    """(m, iterations run per group, deltas): the JAX rule per group, delta
    = inf, while it < iterations and delta > tol: delta = max |new_m - m|
    over the group's rows and m = new_m. deltas [iterations run, groups]:
    each group's delta at each iteration, NaN once it has left (empty at
    tol = 0)."""
    inv2b2 = _inv2b2(bandwidth, X.device)
    rnd = ((lambda t: t.to(torch.bfloat16).to(torch.float32)) if bf16_dots
           else (lambda t: t))
    xd = rnd(X)
    n = X.shape[0]
    group = torch.arange(n, device=X.device) // exit_rows
    active = torch.ones(-(-n // exit_rows), dtype=torch.bool, device=X.device)
    counts = torch.zeros(active.shape, dtype=torch.int64, device=X.device)
    deltas = []
    m = X
    for _ in range(iterations):
        if tol > 0.0 and not bool(active.any()):
            break
        s = rnd(m) @ xd.T
        k = torch.exp((2.0 * s - 2.0) * inv2b2)
        new_m = (rnd(k) @ xd) / (torch.sum(k, dim=1, keepdim=True) + 1e-12)
        new_m = new_m / (torch.linalg.norm(new_m, dim=1, keepdim=True)
                         + 1e-12)
        counts += active
        if tol > 0.0:
            delta = torch.zeros(active.shape, dtype=X.dtype,
                                device=X.device).scatter_reduce(
                0, group, torch.amax(torch.abs(new_m - m), dim=1), "amax")
            m = torch.where(active[group][:, None], new_m, m)
            deltas.append(torch.where(active, delta, float("nan")))
            active = active & (delta > tol)
        else:
            m = new_m
    return m, counts, (torch.stack(deltas) if deltas else
                       torch.empty((0, active.shape[0]), device=X.device))


MS_TILE = 64          # rows of one bf16 tile of X, and of one warpgroup's m
MS_TF32_TILE = 16     # key rows of one tf32 tile (32 KB: X and X^T, hi, lo)
_MS_TILE_ORDER: dict[tuple, torch.Tensor] = {}  # (layout, device) -> index
MS_PART_FLOATS = 2 * (MS_TILE * MS_WIDTH + 2 * 128)  # one block's partial
MS_SPILL_FLOATS = 2 * MS_TILE * MS_WIDTH   # one block's m, spilled (tf32)
MS_M_FLOATS = MS_BLOCK_ROWS * MS_WIDTH     # one row block's m (exit kernels)
# The exit kernels' cap on a block's run, in key tiles of the mode's size:
# EXIT_MIN_RUN of ms_iterations_tc.cu and ms_iterations_tf32.cu, mirrored
# for ms_exit_plan. A run of R tiles of a row block shared by about n_tiles
# / R blocks costs R tiles of work and, in its slot-0 block, one partial
# read from L2 per sharer, so R near sqrt(n_tiles x partial / tile) is
# best: about 8 bf16 tiles and 16 tf32 ones at N = 10,000 (a tile about
# 1.0 / 1.6 us, a partial 0.5 us, estimates; the sweep that chose them is
# in PERF.md §6).
MS_EXIT_MIN_RUN = 8
MS_TF32_EXIT_MIN_RUN = 16
# the exit kernels keep their live set as bits in 448 words of shared memory
MS_EXIT_MAX_ROWS = 448 * 32 * MS_BLOCK_ROWS


@functools.lru_cache(maxsize=None)
def ms_plan(n: int, sms: int, tile: int = MS_TILE,
            n_keys: Optional[int] = None) -> tuple[int, int]:
    """How a tensor-core K1 spreads N query rows against `n_keys` key rows
    (default N) over a card with `sms` SMs: (grid, slots). An iteration is
    blocks x tiles units of work (a 128-row block of m against a `tile`-row
    key tile, blocks = ceil(N / 128), tiles = ceil(n_keys / tile): 64 for
    the bf16 kernel, MS_TF32_TILE for the tf32 one); grid block g takes
    units [floor(g U / grid), floor((g + 1) U / grid)) in row-block-major
    order, as the kernels compute them. With fewer row blocks than SMs,
    grid = min(sms, U): every SM works, at most two row blocks per grid
    block, and the grid blocks sharing a row block add their partial sums
    through the workspace; slots is the most that share one. Otherwise one
    grid block per row block (grid = blocks, slots = 1, no exchange)."""
    blocks = -(-n // MS_BLOCK_ROWS)
    tiles = -(-(n if n_keys is None else n_keys) // tile)
    units = blocks * tiles
    if blocks >= sms:
        return blocks, 1
    grid = min(sms, units)

    def owner(u):   # the largest g with floor(g U / grid) <= u
        return ((u + 1) * grid - 1) // units

    slots = max(owner(b * tiles + tiles - 1) - owner(b * tiles) + 1
                for b in range(blocks))
    return grid, slots


def ms_exit_active(live: int, n_tiles: int, grid: int,
                   tile: int = MS_TILE) -> int:
    """The grid blocks that work an iteration of a K1 exit kernel with
    `live` row blocks still iterating: min(grid, max(1, live x n_tiles //
    the run cap)), 0 once none is left; the cap is MS_EXIT_MIN_RUN bf16
    tiles, or MS_TF32_EXIT_MIN_RUN tf32 ones. It never grows as row blocks
    leave, so a block past it has no more work."""
    if live == 0:
        return 0
    cap = MS_EXIT_MIN_RUN if tile == MS_TILE else MS_TF32_EXIT_MIN_RUN
    return min(grid, max(1, live * n_tiles // cap))


def ms_exit_plan(live_blocks, n_tiles: int, grid: int,
                 tile: int = MS_TILE) -> list:
    """One iteration's work split of a K1 exit kernel, as ms_exit.cuh
    computes it, over the row blocks still iterating (`live_blocks`, in
    ascending order): their len x n_tiles (row block, key tile) units in
    order, grid block g of the `ms_exit_active` taking units [floor(g U /
    active), floor((g + 1) U / active)). -> per working block, its
    segments in order: (row block, t0, t1, first, last), key tiles [t0,
    t1) of the row block, which blocks first..last share. Only a run's
    first and last segments can be shared; each sharer publishes its
    partial of them, and block `first` (slot 0) adds them all and
    decides."""
    live = list(live_blocks)
    units = len(live) * n_tiles
    active = ms_exit_active(len(live), n_tiles, grid, tile)

    def owner(u):   # the largest g with floor(g U / active) <= u
        return ((u + 1) * active - 1) // units

    plan = []
    for g in range(active):
        u0, u1 = g * units // active, (g + 1) * units // active
        c0, c1 = u0 // n_tiles, (u1 - 1) // n_tiles
        plan.append([(live[c], u0 - c * n_tiles if c == c0 else 0,
                      u1 - c * n_tiles if c == c1 else n_tiles,
                      owner(c * n_tiles), owner(c * n_tiles + n_tiles - 1))
                     for c in range(c0, c1 + 1)])
    return plan


def ms_exit_workspace(n: int, grid: int) -> dict:
    """The f32 / int32 elements of each buffer of a K1 exit launch over
    `grid` blocks at N rows, whatever the iterations and the live sets:
    two partials a grid block, of its run's first and last segments
    ("part"), one m a row block ("mstate"), the grid barrier and a flag a
    partial ("counters", zeroed), and the iterations of each row block
    ("iters", zeroed)."""
    blocks = -(-n // MS_BLOCK_ROWS)
    return {"part": 2 * grid * MS_PART_FLOATS,
            "mstate": blocks * MS_M_FLOATS, "counters": 1 + 2 * grid,
            "iters": blocks}


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
    return xb.view(-1, MS_TILE * MS_WIDTH)[:, _tile_order(
        "bf16", X.device)].reshape(-1)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, lo): hi = x rounded to tf32 (10 mantissa bits, to
    nearest, ties away from zero: PTX's cvt.rna.tf32.f32, low 13 bits
    zero), lo = x - hi, exact, so hi + lo == x. The tensor cores read hi
    whole and lo truncated to tf32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


# a k-step's 8 key rows in the order of its slots in the transposed half:
# slot k < 4 holds row 2k, slot k >= 4 row 2 (k - 4) + 1
MS_TF32_SLOT_ROW = (0, 2, 4, 6, 1, 3, 5, 7)


def ms_tiles_tf32(X: torch.Tensor) -> torch.Tensor:
    """The tf32 K1's keys: X [N, D <= 128] f32, zero-padded to
    [ceil(N / 16) * 16, 128], split by `tf32_split` and cut into 16-row
    tiles of 8,192 f32 (32 KB), flat. A tile's first half is its rows x
    features, four 32-column blocks of 32 rows x 128 bytes: the 16 rows'
    hi, then their lo (the operand of S = m X^T: one m64n32k8 takes m hi
    against all 32 rows, an m64n16k8 m lo against the first 16); its
    second half the transpose, 128 feature rows of 32 values (16 key rows'
    hi, then their lo; in each group of 8 the rows in MS_TF32_SLOT_ROW
    order; the operand of O += P X). Both in wgmma's 128-byte swizzle: the
    16-byte chunk j of a 128-byte row r is stored at chunk j ^ (r % 8). So,
    with hl 0 for hi and 1 for lo, element (R, C) of a tile lies at
      1024 (C // 32) + 512 hl + 32 R + 4 (((C % 32) // 4) ^ (R % 8)) + C % 4
    and at 4096 + 32 C + 4 ((s // 4) ^ (C % 8)) + s % 4, slot
    s = 16 hl + 8 (R // 8) + MS_TF32_SLOT_ROW.index(R % 8)."""
    n, d = X.shape
    n_pad = -(-n // MS_TF32_TILE) * MS_TF32_TILE
    xp = torch.zeros((n_pad, MS_WIDTH), dtype=torch.float32, device=X.device)
    xp[:n, :d] = X
    src = torch.stack(tf32_split(xp))                     # [2, n_pad, 128]
    src = src.view(2, -1, MS_TF32_TILE, MS_WIDTH).transpose(0, 1)
    return src.reshape(-1, 2 * MS_TF32_TILE * MS_WIDTH)[
        :, _tile_order("tf32", X.device)].reshape(-1)


def _tile_order(layout: str, device: torch.device) -> torch.Tensor:
    """For each position of a swizzled tile of `layout`, the row-major index
    of the element stored there: for "bf16" into the tile's 64 x 128
    values, for "tf32" into its [2 (hi, lo), 16, 128] values; cached per
    device."""
    key = (layout, str(device))
    if key not in _MS_TILE_ORDER:
        if layout == "bf16":
            half, row, chunk, elem = torch.meshgrid(
                torch.arange(2), torch.arange(MS_TILE), torch.arange(8),
                torch.arange(8), indexing="ij")
            src = row * MS_WIDTH + half * 64 + (chunk ^ (row % 8)) * 8 + elem
        else:
            t, w = MS_TF32_TILE, MS_WIDTH
            kb, hl, row, chunk, elem = torch.meshgrid(
                torch.arange(4), torch.arange(2), torch.arange(t),
                torch.arange(8), torch.arange(4), indexing="ij")
            nat = (hl * t * w + row * w + kb * 32
                   + (chunk ^ (row % 8)) * 4 + elem)
            feat, chunk, elem = torch.meshgrid(
                torch.arange(w), torch.arange(8), torch.arange(4),
                indexing="ij")
            slot = (chunk ^ (feat % 8)) * 4 + elem   # the slot stored there
            kk = slot % 16
            key_row = (8 * (kk // 8)
                       + torch.tensor(MS_TF32_SLOT_ROW)[kk % 8])
            trn = (slot // 16) * t * w + key_row * w + feat
            src = torch.cat([nat.reshape(-1), trn.reshape(-1)])
        _MS_TILE_ORDER[key] = src.reshape(-1).to(device)
    return _MS_TILE_ORDER[key]


def mean_shift_iterations(X: torch.Tensor, bandwidth, iterations: int,
                          bf16_dots: bool = False,
                          tol: float = 0.0) -> torch.Tensor:
    """K1. X: [N, D] f32 unit rows, D <= 128 -> [N, D]. One launch runs all
    iterations on the tensor cores: bf16_dots on ms_iterations_tc.cu, f32
    on ms_iterations_tf32.cu (3xTF32), each on ms_plan's grid. tol > 0
    launches each source's early exit (K1tc_exit, K1_exit) on every SM: a
    128-row block stops once an iteration moves none of its rows by more
    than tol (on the CPU, the plain version with exit_rows =
    MS_BLOCK_ROWS). No iteration returns a copy of X, as the plain version
    does, and launches nothing."""
    if not _on_cuda("mean_shift_iterations", X, scalars=(bandwidth,)):
        return mean_shift_iterations_plain(X, bandwidth, iterations,
                                           bf16_dots, tol, MS_BLOCK_ROWS)
    _check("mean_shift_iterations", X, torch.float32, 2)
    n, d = X.shape
    if n == 0 or d > MS_WIDTH:
        raise ValueError(f"mean_shift_iterations: kernel takes 1 <= N and "
                         f"D <= {MS_WIDTH}, got {tuple(X.shape)}")
    if iterations < 1:
        return X.clone()
    inv2b2 = _inv2b2(bandwidth, X.device)
    sms = _sm_count(X.device)
    if tol > 0.0:
        return _ms_exit(X, inv2b2, int(iterations), sms, tol,
                        bf16_dots)[:, :d]
    if bf16_dots:
        return _ms_iterations_tc(X, inv2b2, int(iterations),
                                 ms_plan(n, sms)[0])[:, :d]
    return _ms_iterations_tf32(X, X, inv2b2, int(iterations),
                               ms_plan(n, sms, MS_TF32_TILE)[0])[:, :d]


def _pad_width(x: torch.Tensor) -> torch.Tensor:
    """[N, D <= 128] f32 -> contiguous [N, 128], zero-padded."""
    if x.shape[1] == MS_WIDTH:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, MS_WIDTH - x.shape[1])).contiguous()


def _ms_iterations_tc(X: torch.Tensor, inv2b2: torch.Tensor, iterations: int,
                      grid: int) -> torch.Tensor:
    """One launch of the tensor-core K1 (K1tc) on CUDA X [N, D <= 128] f32
    over `grid` blocks (ms_plan's, or ceil(N / 128) for no exchange) ->
    [N, 128] f32 (D zero-padded)."""
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


def _ms_exit(X: torch.Tensor, inv2b2: torch.Tensor, iterations: int,
             grid: int, tol: float, bf16_dots: bool,
             iters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of a K1 exit kernel (K1tc_exit for bf16_dots, else
    K1_exit) on CUDA X [N, D <= 128] f32 over at most `grid` blocks (at
    most one per SM; ms_exit_active's of the first iteration) -> [N, 128]
    f32 (D zero-padded). `iters` (int32 [ceil(N / 128)], if given) receives
    the iterations each 128-row block ran."""
    n = X.shape[0]
    if n > MS_EXIT_MAX_ROWS:
        raise ValueError(f"mean_shift_iterations: the early exit takes at "
                         f"most {MS_EXIT_MAX_ROWS} rows, got {n}")
    blocks = -(-n // MS_BLOCK_ROWS)
    tile = MS_TILE if bf16_dots else MS_TF32_TILE
    tiles = -(-n // tile)
    grid = ms_exit_active(blocks, tiles, min(grid, _sm_count(X.device)), tile)
    ws = ms_exit_workspace(n, grid)
    dev = X.device
    part = torch.empty((ws["part"],), dtype=torch.float32, device=dev)
    mstate = torch.empty((ws["mstate"],), dtype=torch.float32, device=dev)
    counters = torch.zeros((ws["counters"],), dtype=torch.int32, device=dev)
    iters = _iters_out(iters, blocks, dev)
    out = torch.empty((n, MS_WIDTH), dtype=torch.float32, device=dev)
    x32 = _pad_width(X)
    operands = ((ms_tiles_bf16(X), x32) if bf16_dots
                else (x32, ms_tiles_tf32(X)))
    _launch("K1tc_exit" if bf16_dots else "K1_exit",
            operands[0].data_ptr(), operands[1].data_ptr(), out.data_ptr(),
            inv2b2.data_ptr(), part.data_ptr(), mstate.data_ptr(),
            iters.data_ptr(), counters.data_ptr(), n, iterations, grid,
            float(tol))
    return out


def _iters_out(iters: Optional[torch.Tensor], blocks: int,
               device: torch.device) -> torch.Tensor:
    """The exit kernels' output of iterations per 128-row block, zeroed (0
    marks a row block still iterating): `iters`, checked, or a new one."""
    if iters is None:
        return torch.zeros((blocks,), dtype=torch.int32, device=device)
    _check("mean_shift_iterations", iters, torch.int32, 1)
    if iters.shape[0] != blocks or iters.device != device:
        raise ValueError(f"mean_shift_iterations: iters must hold {blocks} "
                         f"int32 on {device}, got {tuple(iters.shape)} on "
                         f"{iters.device}")
    return iters.zero_()


def _ms_iterations_tf32(m: torch.Tensor, x: torch.Tensor,
                        inv2b2: torch.Tensor, iterations: int, grid: int,
                        name: str = "K1") -> torch.Tensor:
    """One launch of the tf32 kernel (counted as `name`: K1, or K5 for one
    step of separate queries): `iterations` steps of the queries m [Nq, D
    <= 128] against the keys x [Nk, D], CUDA f32, over `grid` blocks
    (ms_plan's with MS_TF32_TILE, or ceil(Nq / 128) for no exchange) ->
    [Nq, 128] f32 (D zero-padded)."""
    nq, nk = m.shape[0], x.shape[0]
    blocks = -(-nq // MS_BLOCK_ROWS)
    slots = 1 if grid == blocks else ms_plan(nq, grid, MS_TF32_TILE, nk)[1]
    qp = _pad_width(m)
    out = torch.empty((nq, MS_WIDTH), dtype=torch.float32, device=m.device)
    ws = torch.empty((2 * blocks * slots * MS_PART_FLOATS
                      + grid * MS_SPILL_FLOATS if grid > blocks else 1,),
                     dtype=torch.float32, device=m.device)
    counters = torch.zeros((blocks,), dtype=torch.int32, device=m.device)
    _launch(name, qp.data_ptr(), ms_tiles_tf32(x).data_ptr(), out.data_ptr(),
            inv2b2.data_ptr(), ws.data_ptr(), counters.data_ptr(), nq, nk,
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
    """K5: one iteration of K1 f32's kernel (ms_iterations_tf32.cu) with the
    queries apart from the keys. m [Nq, D], x [Nk, D] f32, D <= 128,
    inv2b2 = 1 / (2 b^2) -> [Nq, D]. The key columns are masked by Nk; the
    TPU kernel masks them by Nq, which agrees at m = x, its only use."""
    if not _on_cuda("mean_shift_step", m, x, scalars=(inv2b2,)):
        return mean_shift_step_plain(m, x, inv2b2)
    _check("mean_shift_step m", m, torch.float32, 2)
    _check("mean_shift_step x", x, torch.float32, 2)
    (nq, d), nk = m.shape, x.shape[0]
    if nq == 0 or nk == 0 or d > MS_WIDTH or x.shape[1] != d:
        raise ValueError(f"mean_shift_step: kernel takes non-empty [Nq, D] "
                         f"and [Nk, D], D <= {MS_WIDTH}, got "
                         f"{tuple(m.shape)}, {tuple(x.shape)}")
    inv = torch.as_tensor(inv2b2, dtype=torch.float32,
                          device=m.device).reshape(1).contiguous()
    grid = ms_plan(nq, _sm_count(m.device), MS_TF32_TILE, nk)[0]
    return _ms_iterations_tf32(m, x, inv, 1, grid, "K5")[:, :d]


# The tf32 kernel's operand probe (ms_iterations_tf32.cu; chip_smoke.py
# phase 6): mode -> (bytes of operands read from shared memory, FMA) of one
# consumer warpgroup's key tile, in the C entry's order. The score modes
# differ only in where their operands lie (ss3: three m64n16k8 a k-step,
# m hi read twice; n32: the exit's; rs_hi: the fixed-count kernel's; rs: m
# hi and lo both from registers); "update" is the tile's O += P X.
_SCORE_FMA = 3 * 64 * 16 * 128
_SCORE_BYTES = {"ss3": 48 * (2048 + 512), "n32": 16 * (3072 + 2560),
                "rs_hi": 16 * (1024 + 2560), "rs": 16 * (1024 + 512)}
_UPDATE_BYTES = 6 * 4096
MS_TF32_PROBE = {
    **{f"score_{k}": (v, _SCORE_FMA) for k, v in _SCORE_BYTES.items()},
    "update": (_UPDATE_BYTES, _SCORE_FMA),
    **{f"score_{k}+update": (v + _UPDATE_BYTES, 2 * _SCORE_FMA)
       for k, v in _SCORE_BYTES.items()},
}


def ms_tf32_operand_probe(device, mode: str, tiles: int = 4096) -> dict:
    """One launch of the tf32 kernel's operand probe on every SM of
    `device`: both consumer warpgroups of each block run `tiles` key tiles
    of `mode` (MS_TF32_PROBE) against operands held in shared memory. ->
    the clock64 cycles a warpgroup took a tile (mean over the grid) and
    the launch's ms (CUDA events). Counted in no LAUNCHES entry: it is a
    measurement, not a kernel of a path."""
    if "K1" not in _LIBS:
        build_kernels()
    fn = _LIBS["K1"].ms_tf32_operand_probe
    fn.argtypes = [_P, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    grid = _sm_count(device)
    cycles = torch.zeros(2 * grid, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    rc = fn(cycles.data_ptr(), list(MS_TF32_PROBE).index(mode), int(tiles),
            grid, stream.cuda_stream)
    end.record(stream)
    if rc != 0:
        raise RuntimeError(f"kernels: ms_tf32_operand_probe failed with "
                           f"cudaError {rc}")
    end.synchronize()
    return {"cycles_per_tile": float(cycles.double().mean()) / tiles,
            "ms": start.elapsed_time(end)}


# ---------------------------------------------------------------------------
# K2: auction assignment
# ---------------------------------------------------------------------------

AUCTION_NEG = -1e9
AUCTION_ROUNDS = 512  # round cap, as the TPU kernel's static trip count
AUCTION_MAX_N = 64    # the kernel's largest padded size
LAP_TIE = 1e-7        # column-linear tie-breaker slope (exactness-neutral)
LAP_BETA = 2e-5       # diagonal parking bonus for uniform rows
LAP_UNIFORM = 1e-6    # a row whose span is at most this is uniform


def lap_benefit(cost: torch.Tensor) -> torch.Tensor:
    """Auction benefit of a cost matrix [..., n, n]: -(cost + LAP_TIE j),
    plus LAP_BETA on the diagonal of uniform rows (see ops/hungarian.py)."""
    n = cost.shape[-1]
    cost = cost.to(torch.float32)
    row_span = torch.amax(cost, dim=-1) - torch.amin(cost, dim=-1)
    uniform = (row_span <= LAP_UNIFORM).to(torch.float32)
    tie = LAP_TIE * torch.arange(n, dtype=torch.float32, device=cost.device)
    eye = torch.eye(n, dtype=torch.float32, device=cost.device)
    park = LAP_BETA * uniform[..., :, None] * eye
    return -(cost + tie) + park


def complete_assignment(assignment: torch.Tensor) -> torch.Tensor:
    """Rows with -1 take the leftover columns, r-th such row -> r-th free
    column. assignment [n] int -> permutation [n] int32."""
    n = assignment.shape[-1]
    a = assignment.to(torch.int64)
    assigned = a >= 0
    col_taken = torch.zeros(n + 1, dtype=torch.bool, device=a.device)
    col_taken[torch.where(assigned, a, n)] = True
    ar = torch.arange(n, device=a.device)
    free_cols = torch.sort(torch.where(col_taken[:n], n, ar)).values
    fill_rank = torch.cumsum((~assigned).to(torch.int64), dim=0) - 1
    fill = free_cols[torch.clamp(fill_rank, 0, n - 1)]
    return torch.where(assigned, a, fill).to(torch.int32)


def _pad_benefit(benefit: torch.Tensor) -> torch.Tensor:
    """[B, n, n] -> [B, n_pad, n_pad], n_pad = max(8, ceil8(n)): padding
    entries -1e6, padding persons parked on their own padding object (+1)."""
    b, n, _ = benefit.shape
    n_pad = max(8, -(-n // 8) * 8)
    out = torch.full((b, n_pad, n_pad), -1e6, dtype=torch.float32,
                     device=benefit.device)
    out[:, :n, :n] = benefit
    torch.diagonal(out, dim1=1, dim2=2)[:, n:].fill_(-1e6 + 1.0)
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


def lap_assign_plain(cost: torch.Tensor, eps0: float, esc_every: int,
                     esc: float, max_iter: int) -> torch.Tensor:
    """solve_lap in PyTorch ops: lap_benefit, auction_assign_plain and
    complete_assignment of each matrix. cost [n, n] or [B, n, n] ->
    col_of_row [n] / [B, n] int32, each a permutation."""
    squeeze = cost.dim() == 2
    c3 = cost[None] if squeeze else cost
    a = auction_assign_plain(lap_benefit(c3), eps0, esc_every, esc, max_iter)
    out = torch.stack([complete_assignment(row) for row in a])
    return out[0] if squeeze else out


def _auction_check(name: str, x: torch.Tensor, esc_every: int) -> None:
    """What K2's entries take: f32 [n, n] or [B, n, n], 1 <= n <= 64, B >= 1,
    esc_every > 0."""
    if (x.dim() not in (2, 3) or x.shape[-1] != x.shape[-2]
            or x.dtype != torch.float32):
        raise ValueError(f"{name}: expected float32 [n, n] or [B, n, n], got "
                         f"{tuple(x.shape)} {x.dtype}")
    n = x.shape[-1]
    if not 1 <= n <= AUCTION_MAX_N or x.numel() == 0 or int(esc_every) <= 0:
        raise ValueError(f"{name}: kernel takes 1 <= n <= {AUCTION_MAX_N}, a "
                         f"non-empty batch and esc_every > 0, got "
                         f"{tuple(x.shape)}, esc_every {esc_every}")


def _auction_launch(name: str, x: torch.Tensor, eps0: float, esc_every: int,
                    esc: float, max_iter: int, *consts) -> torch.Tensor:
    squeeze = x.dim() == 2
    x3 = (x[None] if squeeze else x).contiguous()
    bsz, n, _ = x3.shape
    out = torch.empty((bsz, n), dtype=torch.int32, device=x3.device)
    _launch(name, x3.data_ptr(), out.data_ptr(), bsz, n, float(eps0),
            int(esc_every), float(esc), min(int(max_iter), AUCTION_ROUNDS),
            *consts)
    return out[0] if squeeze else out


def auction_assign(benefit: torch.Tensor, eps0: float, esc_every: int,
                   esc: float, max_iter: int) -> torch.Tensor:
    """K2_benefit. Forward auction on prepared benefit matrices [n, n] or
    [B, n, n] (higher = better), one block per matrix, padded inside the
    kernel, min(max_iter, 512) rounds. Returns obj_of_person int32 (-1 where
    a person is left unassigned)."""
    if benefit.device.type != "cpu":
        _auction_check("auction_assign", benefit, esc_every)
    if not _on_cuda("auction_assign", benefit):
        return auction_assign_plain(benefit, eps0, esc_every, esc, max_iter)
    return _auction_launch("K2_benefit", benefit, eps0, esc_every, esc,
                           max_iter)


def lap_assign(cost: torch.Tensor, eps0: float, esc_every: int, esc: float,
               max_iter: int) -> torch.Tensor:
    """K2. The whole solve_lap of cost matrices [n, n] or [B, n, n] in one
    launch, one block per matrix: lap_benefit, the auction
    (min(max_iter, 512) rounds) and the rank fill. Returns col_of_row
    int32, each row a permutation."""
    if cost.device.type != "cpu":
        _auction_check("lap_assign", cost, esc_every)
    if not _on_cuda("lap_assign", cost):
        return lap_assign_plain(cost, eps0, esc_every, esc, max_iter)
    return _auction_launch("K2", cost, eps0, esc_every, esc, max_iter,
                           LAP_TIE, LAP_BETA, LAP_UNIFORM)


def auction_latency_probe(device, threads: int, iters: int = 4096) -> dict:
    """The latencies K2's bound is made of, by `auction_probe` (clock64 in
    one block of `threads` on `device`): cycles per barrier, per dependent
    shuffle step (shfl + fmax) and per dependent redux.sync, and the SM
    clock in GHz over the probe (cycles over globaltimer ns). Counted in no
    LAUNCHES entry: it is a measurement, not a kernel of a path."""
    if "K2" not in _LIBS:
        build_kernels()
    fn = _LIBS["K2"].auction_probe
    fn.argtypes = [_P, _I, _I, _P]
    fn.restype = ctypes.c_int
    out = torch.zeros(6, dtype=torch.int64, device=device)
    rc = fn(out.data_ptr(), int(threads), int(iters),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernels: auction_probe failed with cudaError "
                           f"{rc}")
    c = out.tolist()
    return {"barrier_cycles": c[0] / iters,
            "shuffle_step_cycles": c[1] / iters,
            "redux_cycles": c[2] / iters, "clock_ghz": c[3] / c[4]}


# ---------------------------------------------------------------------------
# K3: min squared distance with argmin
# ---------------------------------------------------------------------------

MIN_SQDIST_BIG = 1e30  # masked targets (the TPU kernel's constant)
PLAIN_QUERY_CHUNK = 8192  # query rows per [chunk, M] block of the plain version
# K3's launch plan (`min_sqdist_plan`); the three model constants were read
# off split sweeps at the main-path shapes on an H100 (PERF.md §6)
MSQ_MAX_THREADS = 256  # the kernel's largest block
MSQ_BLOCK_COST = 64    # a block's fixed work, in targets scanned
MSQ_SAT_WARPS = 8      # warps an SM needs to run the scan at full rate
MSQ_MAX_BLOCKS_PER_SM = 16  # the most blocks an SM's share the plan weighs
MSQ_MIN_CHUNK = 128    # fewest targets a split is given
_SMS: dict[int, int] = {}  # CUDA device index -> SM count


def _penalty(x: torch.Tensor, x_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if x_mask is None:
        return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    return torch.where(x_mask > 0, 0.0, MIN_SQDIST_BIG).to(torch.float32)


@functools.lru_cache(maxsize=4096)
def min_sqdist_plan(b: int, n: int, m: int, sms: int) -> tuple[int, int, int]:
    """How K3 spreads B patches of N queries against M targets over a card
    with `sms` SMs: (r, threads, splits). Each thread keeps r queries (8 from
    N = 2,048 up, else 4), a block has `threads` (the fewest warps that hold
    a patch's queries, at most 256) and covers threads * r queries of one
    patch; each patch's targets are cut into `splits` chunks of
    ceil(M / splits), so the grid is ceil(N / (threads r)) x splits x B
    blocks, no chunk is empty and none is cut below MSQ_MIN_CHUNK targets
    (a second pass merges the splits; small shapes are not worth one).

    splits minimises a model of the time: the busiest SM runs k =
    ceil(blocks / sms) blocks, each scanning its chunk plus
    MSQ_BLOCK_COST targets' worth of fixed work, at full rate once it holds
    MSQ_SAT_WARPS warps and proportionally slower below. For each k the
    largest splits with that k is the candidate (smaller chunks at the same
    k); more splits shorten the chunks, fewer cut the fixed work."""
    def ceil(a, c):
        return -(-a // c)

    r = 8 if n >= 2048 else 4
    threads = min(MSQ_MAX_THREADS, 32 * ceil(ceil(n, r), 32))
    warps = threads // 32
    base = b * ceil(n, threads * r)
    best = None
    for k in range(1, MSQ_MAX_BLOCKS_PER_SM + 1):
        s = min(max(1, k * sms // base), ceil(m, MSQ_MIN_CHUNK))
        per_sm = ceil(base * s, sms)
        cost = (per_sm * (ceil(m, s) + MSQ_BLOCK_COST)
                / min(1.0, per_sm * warps / MSQ_SAT_WARPS))
        if best is None or cost < best[0]:
            best = (cost, s)
    return r, threads, ceil(m, ceil(m, best[1]))


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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
    launch (and a merging one where `min_sqdist_plan` splits the targets).
    No backward: see `MinSqdist`."""
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
    if mask3 is not None:
        mask3 = mask3.to(torch.float32).contiguous()
    r, threads, splits = min_sqdist_plan(b, n, m, _sm_count(q.device))
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws = (torch.empty((2 * splits * b * n,), dtype=torch.int32,
                      device=q.device) if splits > 1 else None)
    _launch("K3", q3.data_ptr(), x3.data_ptr(),
            0 if mask3 is None else mask3.data_ptr(), out.data_ptr(),
            idx.data_ptr(), 0 if ws is None else ws.data_ptr(), b, n, m, r,
            threads, splits)
    return (out[0], idx[0]) if squeeze else (out, idx)


# ---------------------------------------------------------------------------
# K4: backward of the differentiable min squared distance
# ---------------------------------------------------------------------------

K4_CHUNK = 9216      # targets per block of K4
K4_SMEM = 232448     # shared memory a block can have
K4_ENTRY_BYTES = 16  # a query's entry (dq, next), and a target's x + head


def ordered_scatter_sub(rows: torch.Tensor, vals: torch.Tensor,
                        size: int) -> torch.Tensor:
    """out[r] = ((0 - vals[i1]) - vals[i2]) - ... over the i with rows[i] ==
    r, in ascending i: a scatter of -vals whose sum order is fixed, the same
    on every device and in every run. rows [Q] int, vals [Q, C] ->
    [size, C]. One masked update per rank within a row (a stable sort gives
    the ranks), so the loop runs as often as the most-picked row is picked."""
    out = torch.zeros((size, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    if rows.numel() == 0:
        return out
    r, order = torch.sort(rows, stable=True)
    v = vals[order]
    pos = torch.arange(r.numel(), device=r.device)
    first = torch.ones_like(r, dtype=torch.bool)
    first[1:] = r[1:] != r[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        out[r[sel]] = out[r[sel]] - v[sel]
    return out


def min_sqdist_bwd_plain(q: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                         g: torch.Tensor):
    """dq = 2 (q - x[idx]) g, dx = scatter of -dq at idx summed in ascending
    query order (`ordered_scatter_sub`), as K4 sums it. q [B, N, 3], x [B, M,
    3], idx, g [B, N] -> (dq, dx)."""
    b, m = x.shape[0], x.shape[1]
    rows = (idx.long() + m * torch.arange(b, device=x.device)[:, None])
    xa = x.reshape(b * m, 3)[rows.reshape(-1)].reshape(q.shape)
    dq = 2.0 * (q - xa) * g[..., None]
    dx = ordered_scatter_sub(rows.reshape(-1), dq.reshape(-1, 3), b * m)
    return dq, dx.reshape(x.shape)


def min_sqdist_bwd(q: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                   g: torch.Tensor):
    """K4. The backward of `MinSqdist` for q [B, N, 3], x [B, M, 3], the
    forward's argmin idx [B, N] int32 and the incoming gradient g [B, N] f32
    -> (dq [B, N, 3], dx [B, M, 3]), one launch. Both are bitwise the plain
    version's: dx sums each target's queries in ascending query order, so
    runs repeat (the kernel leaves out queries whose dq is zero, which
    changes no bit and keeps a target's chain to the queries that move it)."""
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
    return _min_sqdist_bwd(q, x, idx, g)


def _min_sqdist_bwd(q: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                    g: torch.Tensor):
    """K4 without the checks, for `MinSqdist.backward`, whose forward has
    checked q, x and the argmin: a CUDA q launches the kernel, a CPU q
    takes the plain version."""
    if q.device.type != "cuda":
        return min_sqdist_bwd_plain(q, x, idx, g)
    (b, n, _), m = q.shape, x.shape[1]
    dq = torch.empty_like(q)
    dx = torch.empty_like(x)
    # the query entries go to device memory where they do not fit in a
    # block's shared memory beside the target chunk
    ws = (torch.empty((b * n * 4,), dtype=torch.float32, device=q.device)
          if K4_ENTRY_BYTES * (n + min(m, K4_CHUNK)) > K4_SMEM else None)
    _launch("K4", q.data_ptr(), x.data_ptr(), idx.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dx.data_ptr(), 0 if ws is None else ws.data_ptr(),
            b, n, m)
    return dq, dx


class MinSqdist(torch.autograd.Function):
    """Differentiable min squared distance, min_sqdist_fused's counterpart:
    the forward is K3 (saving q, x and the argmin), the backward K4, the
    subgradient through the argmin. q [B, N, 3], x [B, M, 3], optional
    x_mask [B, M] (not differentiated) -> [B, N]. On the card the forward's
    checks (contiguous f32 [B, N, 3] and [B, M, 3]) stand for the
    backward's: it launches K4 through `_min_sqdist_bwd`."""

    @staticmethod
    def forward(ctx, q, x, x_mask=None):
        if q.dim() != 3:
            raise ValueError(f"MinSqdist: expected q [B, N, 3], got "
                             f"{tuple(q.shape)}")
        d, idx = min_sqdist_with_idx(q, x, x_mask)
        ctx.save_for_backward(q, x, idx)
        return d

    @staticmethod
    def backward(ctx, g):
        q, x, idx = ctx.saved_tensors
        dq, dx = _min_sqdist_bwd(q, x, idx, g.contiguous())
        return (dq if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None, None)
