"""On the card: K1 f32's fixed-count kernel (ms_iterations_tf32.cu, m hi
and m lo from registers) held to the plain f32 version at the main path's
shapes, and its early exit (m from shared memory) to the plain version and
to the fixed-count run. Imports no JAX: on the card run

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_ms_tf32_card.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card

# chip_smoke.py's limits for the tf32 kernel against the plain f32 version:
# max |d| after one iteration, and after the last
TOL_1 = 1e-5
TOL_LAST = 1e-3
# the early exit at tol 1e-6 against the fixed-count run of the same launch
TOL_EXIT = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("runs the CUDA kernels: needs a CUDA card")
    from parsenet_tpu_torch.ops import kernels
    kernels.build_kernels()
    return torch.device("cuda", 0)


def _clustered(device, seed, n, d=128, k=24, noise=0.08):
    """n unit rows around k random unit centres, as embeddings cluster."""
    rng = np.random.RandomState(seed)
    c = rng.randn(k, d)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.randint(0, k, n)] + noise * rng.randn(n, d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _max_abs(a, b):
    return float((a - b).abs().max())


# (rows, iterations): e2e-segment's clustering of a 10,000-point shape and
# e2e fine-tuning's escalation attempts on 8,000 points
@pytest.mark.parametrize("n,iterations", [(10000, 50), (8000, 5)])
def test_fixed_count_k1_f32_matches_plain(card, n, iterations):
    from parsenet_tpu_torch.ops import kernels
    x = _clustered(card, n, n)
    bw = 0.0837
    for it, tol in ((1, TOL_1), (iterations, TOL_LAST)):
        kernels.reset_launches()
        got = kernels.mean_shift_iterations(x, bw, it)
        assert kernels.LAUNCHES["K1"] == 1
        ref = kernels.mean_shift_iterations_plain(x, bw, it)
        assert _max_abs(got, ref) <= tol, (it, _max_abs(got, ref))
    # one block per 128 rows: no partial sums exchanged
    inv = kernels._inv2b2(bw, card)
    one = kernels._ms_iterations_tf32(x, x, inv, iterations,
                                      -(-n // kernels.MS_BLOCK_ROWS))
    ref = kernels.mean_shift_iterations_plain(x, bw, iterations)
    assert _max_abs(one, ref) <= TOL_LAST


def test_k5_step_matches_plain(card):
    """K5, the kernel's one-iteration run with queries apart from the keys,
    at 10,000 perturbed queries and at 300 queries against 1,000 keys."""
    from parsenet_tpu_torch.ops import kernels
    x = _clustered(card, 7, 10000)
    g = torch.Generator(card).manual_seed(7)
    m = x + 0.01 * torch.randn(x.shape, device=card, generator=g)
    m = m / m.norm(dim=1, keepdim=True)
    inv2b2 = 1.0 / (2.0 * 0.0837 ** 2)
    for q, k in ((m, x), (m[:300].contiguous(), x[:1000].contiguous())):
        got = kernels.mean_shift_step(q, k, inv2b2)
        assert _max_abs(got, kernels.mean_shift_step_plain(q, k, inv2b2)) \
            <= TOL_1


def test_k1_exit_f32_at_tol_1e6(card):
    """The early exit (m hi and lo from shared memory): two launches equal
    bit for bit, within the 50-iteration limit of the plain version and
    within TOL_EXIT of the fixed-count kernel's run."""
    from parsenet_tpu_torch.ops import kernels
    x = _clustered(card, 10000, 10000)
    bw = 0.0837
    kernels.reset_launches()
    a = kernels.mean_shift_iterations(x, bw, 50, tol=1e-6)
    b = kernels.mean_shift_iterations(x, bw, 50, tol=1e-6)
    assert kernels.LAUNCHES["K1_exit"] == 2
    assert torch.equal(a, b)
    assert _max_abs(a, kernels.mean_shift_iterations_plain(x, bw, 50)) \
        <= TOL_LAST
    assert _max_abs(a, kernels.mean_shift_iterations(x, bw, 50)) <= TOL_EXIT


def _poison_free_blocks(device, chunk=2 << 20):
    """Fill the memory the caching allocator holds free with NaN: chunks
    allocated until the allocator has to reserve more, then freed."""
    held, reserved = [], torch.cuda.memory_reserved(device)
    while True:
        held.append(torch.full((chunk // 4,), float("nan"), device=device))
        if torch.cuda.memory_reserved(device) > reserved:
            break
    del held


def test_key_operands_outlive_the_launch(card, monkeypatch):
    """The wrapper keeps both key operands (ms_tiles_tf32, ms_tiles_hi16)
    allocated until the launch is queued: memory freed before the launch
    could be handed to work queued before it. With every free block filled
    with NaN just before the launch, the result stays the plain version's."""
    from parsenet_tpu_torch.ops import kernels
    real = kernels._launch

    def launch(name, *args):
        _poison_free_blocks(card)
        real(name, *args)

    x = _clustered(card, 3, 10000)
    bw = 0.0837
    ref = kernels.mean_shift_iterations_plain(x, bw, 1)
    monkeypatch.setattr(kernels, "_launch", launch)
    for grid in (kernels.ms_plan(10000, kernels._sm_count(card),
                                 kernels.MS_TF32_TILE)[0],
                 -(-10000 // kernels.MS_BLOCK_ROWS)):
        got = kernels._ms_iterations_tf32(x, x, kernels._inv2b2(bw, card), 1,
                                          grid)
        assert _max_abs(got, ref) <= TOL_1
