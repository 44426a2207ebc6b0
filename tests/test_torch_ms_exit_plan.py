"""The K1 exit kernels' work split (kernels.ms_exit_plan, the Python mirror
of ms_exit.cuh's exit_plan / exit_owner), their workspaces, and an
emulation of one exit launch's schedule against the plain version. The
kernels themselves are held to the plain version on the card
(chip_smoke.py phase 3)."""
import re

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _live_sets(rng, blocks, k=4):
    """All row blocks, one, and k random live sets of random sizes."""
    sets = [list(range(blocks)), [int(rng.randint(blocks))]]
    for _ in range(k):
        size = int(rng.randint(1, blocks + 1))
        sets.append(sorted(rng.choice(blocks, size, replace=False).tolist()))
    return sets


@pytest.mark.parametrize("tile", [kernels.MS_TILE, kernels.MS_TF32_TILE])
@pytest.mark.parametrize("n,grid", [(100, 132), (1000, 132), (4999, 132),
                                    (10000, 132), (10000, 8), (10000, 1),
                                    (20000, 132), (40000, 132), (700, 5)])
def test_ms_exit_plan_covers_every_live_unit(n, grid, tile):
    """For random live sets: every (live row block, key tile) unit lies in
    exactly one block's run, runs are contiguous in live order; no run is
    below the cap (the mode's run cap in tiles) unless one block takes all; at
    most `grid` blocks work. What a block keeps for its segments is
    bounded whatever their number: only its run's first and last segments
    can be shared, so it publishes at most two partials (the workspace's
    two a block) and a row block's middle segments are whole; slot 0 is
    the block holding the row block's first tile, and the sharers of a row
    block are consecutive blocks within the grid."""
    rng = np.random.RandomState(n + grid + tile)
    blocks, tiles = -(-n // kernels.MS_BLOCK_ROWS), -(-n // tile)
    min_run = (kernels.MS_EXIT_MIN_RUN if tile == kernels.MS_TILE
               else kernels.MS_TF32_EXIT_MIN_RUN)
    for live in _live_sets(rng, blocks):
        plan = kernels.ms_exit_plan(live, tiles, grid, tile)
        active = len(plan)
        assert active == kernels.ms_exit_active(len(live), tiles, grid, tile)
        assert 1 <= active <= grid
        covered = {}
        order = []
        for g, segs in enumerate(plan):
            run = sum(t1 - t0 for _, t0, t1, _, _ in segs)
            assert run >= min_run or active == 1, (g, run)
            assert len(segs) <= -(-run // tiles) + 1
            for k, (b, t0, t1, first, last) in enumerate(segs):
                assert 0 <= t0 < t1 <= tiles and first <= g <= last < active
                assert (t0 == 0) == (first == g)
                if k > 0:
                    assert t0 == 0
                if k < len(segs) - 1:
                    assert t1 == tiles
                if 0 < k < len(segs) - 1:
                    assert first == last == g     # middle segments: whole
                for t in range(t0, t1):
                    assert (b, t) not in covered
                    covered[(b, t)] = g
                order.extend((b, t) for t in range(t0, t1))
        assert order == [(b, t) for b in live for t in range(tiles)]


@pytest.mark.parametrize("source,cap", [
    ("ms_iterations_tc.cu", kernels.MS_EXIT_MIN_RUN),
    ("ms_iterations_tf32.cu", kernels.MS_TF32_EXIT_MIN_RUN)])
def test_exit_min_run_mirrors_the_source(source, cap):
    """ms_exit_plan's run cap is the one each kernel source compiles in."""
    text = (kernels.CSRC / source).read_text()
    assert re.findall(r"constexpr int EXIT_MIN_RUN = (\d+);", text) == [
        str(cap)]


def test_ms_exit_active_never_grows():
    """As row blocks leave, the working blocks never grow, so a block past
    ms_exit_active has no more work and may leave the launch; none work
    once every row block has left."""
    for tile in (kernels.MS_TILE, kernels.MS_TF32_TILE):
        for n in (100, 4999, 10000, 40000):
            blocks, tiles = -(-n // 128), -(-n // tile)
            act = [kernels.ms_exit_active(a, tiles, 132, tile)
                   for a in range(blocks, -1, -1)]
            assert all(x >= y for x, y in zip(act, act[1:]))
            assert act[-1] == 0 and act[0] >= 1


@pytest.mark.parametrize("n,grid", [(1, 1), (100, 132), (10000, 132),
                                    (10000, 3), (100000, 132),
                                    (1000000, 132)])
def test_ms_exit_workspace_bounded_by_grid_and_n(n, grid):
    """An exit launch's buffers follow from the grid and N alone: two
    partials a grid block, one m a row block, a barrier count and a flag a
    partial, one count a row block; none grows with the iterations or the
    live sets (the old workspaces were sized by row blocks x sharers)."""
    blocks = -(-n // 128)
    ws = kernels.ms_exit_workspace(n, grid)
    assert ws == {"part": 2 * grid * kernels.MS_PART_FLOATS,
                  "mstate": blocks * 128 * kernels.MS_WIDTH,
                  "counters": 2 * grid + 1, "iters": blocks}
    assert ws["part"] * 4 <= 2 * 132 * 68 * 1024   # 17.8 MB on 132 SMs


def _emulate_exit(x, bandwidth, iterations, tol, grid, tile):
    """An exit launch's schedule in float64: each iteration, the live row
    blocks' units split by ms_exit_plan; each row block's O and row sums
    added over its sharers' runs in slot order; the rule on each row
    block's delta. -> (m, iterations per row block, working blocks per
    iteration)."""
    n = x.shape[0]
    blocks, tiles = -(-n // 128), -(-n // tile)
    inv2b2 = 1.0 / (2.0 * bandwidth * bandwidth)
    m = x.copy()
    counts = np.zeros(blocks, np.int64)
    live = list(range(blocks))
    active = []
    for it in range(iterations):
        plan = kernels.ms_exit_plan(live, tiles, grid, tile)
        active.append(len(plan))
        sums = {}
        for segs in plan:
            for b, t0, t1, _, _ in segs:
                rows = slice(128 * b, min(n, 128 * (b + 1)))
                keys = slice(t0 * tile, min(n, t1 * tile))
                k = np.exp((2.0 * m[rows] @ x[keys].T - 2.0) * inv2b2)
                o, rs = sums.get(b, (0.0, 0.0))
                sums[b] = (o + k @ x[keys], rs + k.sum(1, keepdims=True))
        assert sorted(sums) == live
        for b in live:
            rows = slice(128 * b, min(n, 128 * (b + 1)))
            o, rs = sums[b]
            new = o / (rs + 1e-12)
            new /= np.linalg.norm(new, axis=1, keepdims=True) + 1e-12
            delta = np.abs(new - m[rows]).max()
            m[rows] = new
            counts[b] = it + 1
            if not delta > tol:
                live = [c for c in live if c != b]
        if not live:
            break
    return m, counts, active


@pytest.mark.parametrize("grid,tile", [(132, kernels.MS_TF32_TILE),
                                       (5, kernels.MS_TF32_TILE),
                                       (132, kernels.MS_TILE)])
def test_exit_schedule_matches_plain(rng, grid, tile):
    """The schedule of one exit launch (every live row block's units once
    an iteration, the live set shrinking by the rule) gives the plain
    version's iterations per 128-row block and its m within 1e-10 (both
    in float64); the working blocks never grow."""
    c = rng.randn(5, 32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    # tight clusters in the first half of the rows (their row blocks leave
    # within a few iterations), loose ones after
    noise = np.where(np.arange(900) < 450, 0.02, 0.2)[:, None]
    x = c[np.sort(rng.randint(0, 5, 900))] + noise * rng.randn(900, 32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    m, counts, active = _emulate_exit(x, 0.25, 30, 1e-6, grid, tile)
    xt = torch.from_numpy(x)
    want = kernels.mean_shift_iterations_plain(xt, 0.25, 30, tol=1e-6,
                                               exit_rows=128)
    want_counts = kernels.mean_shift_exit_counts(xt, 0.25, 30, tol=1e-6)
    np.testing.assert_array_equal(counts, want_counts.numpy())
    assert int(want_counts.min()) < int(want_counts.max()), want_counts
    np.testing.assert_allclose(m, want.numpy(), rtol=0, atol=1e-10)
    assert all(a >= b for a, b in zip(active, active[1:])), active
