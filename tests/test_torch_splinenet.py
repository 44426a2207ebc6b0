"""Port parity: SplineNet (models/splinenet.py) against the flax model, in
eval and train mode, with and without per-point weights, from a flax init
carried across and from the shipped weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import flatten_tree
from parsenet_tpu.models.splinenet import SplineNet as JaxSplineNet
from parsenet_tpu_torch.models import splinenet as tsn

torch.set_num_threads(1)

GRID, K, B, N = 8, 4, 4, 96


def carried(mode: int, grid: int = GRID, k: int = K, n: int = N):
    """A flax SplineNet initialised with PRNGKey(0) and the port's copy."""
    jm = JaxSplineNet(grid=grid, k=k, mode=mode)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, n, 3)),
                        train=False)
    flat = {k_: np.asarray(v) for k_, v in flatten_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()}
    tm = tsn.SplineNet(grid=grid, k=k, mode=mode)
    tm.load_state_dict(tsn.params_from_jax(flat, tm))
    return jm, variables, tm


def _points(rng, b=B, n=N):
    """Points in the unit box, as canonicalised patches are."""
    return (rng.rand(b, n, 3) - 0.5).astype(np.float32)


@pytest.mark.parametrize("mode", [0, 1])
def test_eval_forward_matches_flax(rng, mode):
    jm, variables, tm = carried(mode)
    x = _points(rng)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (B, GRID * GRID, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1])
def test_train_forward_and_batch_stats_match_flax(rng, mode):
    """Batch moments in every BatchNorm, and flax's running-average update
    (momentum 0.9, biased variance): batch_stats within 1e-5. The output
    within 1e-4: bn6 and bn7 normalise over the 4 patches of the batch,
    which turns f32 rounding of about 1e-5 in conv6's output into about
    1e-4 at the end (measured: up to 7.3e-5)."""
    jm, variables, tm = carried(mode)
    x = _points(rng)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    want = {k: np.asarray(v) for k, v in flatten_tree(
        {"batch_stats": mut["batch_stats"]}).items()}
    have = tsn.params_to_jax(tm)
    assert len(want) == 14
    for key, val in want.items():
        np.testing.assert_allclose(have[key], val, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_weighted_max_pool_matches_flax(rng):
    jm, variables, tm = carried(0)
    x = _points(rng)
    w = rng.rand(B, N).astype(np.float32)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(w), train=False)
    got = tm.eval()(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    unweighted = tm(torch.from_numpy(x))
    assert not torch.allclose(got, unweighted)


def test_round_trip_and_leftover_keys_raise():
    jm, variables, tm = carried(0)
    flat = tsn.params_to_jax(tm)
    assert len(flat) == 43
    assert flat["params/conv5/kernel"].shape == (512, 1024)
    tm2 = tsn.SplineNet(grid=GRID, k=K, mode=0)
    tm2.load_state_dict(tsn.params_from_jax(flat, tm2))
    for a, b in zip(tm.state_dict().values(), tm2.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(KeyError, match="unused"):
        tsn.params_from_jax({**flat, "params/extra/kernel": np.zeros(1)}, tm2)
    missing = dict(flat)
    del missing["batch_stats/bn5/var"]
    with pytest.raises(KeyError, match="unset"):
        tsn.params_from_jax(missing, tm2)


@pytest.mark.parametrize("name,mode", [("open", 0), ("closed", 1)])
def test_shipped_weights_eval_forward(rng, name, mode):
    from parsenet_tpu.core.checkpoint import load_npz_params
    path = f"params/{name}_splinenet.npz"
    tree = load_npz_params(path)
    jm = JaxSplineNet(grid=20, k=10, mode=mode)
    tm = tsn.load_splinenet(path, mode, device="cpu")
    assert len(tsn.params_to_jax(tm)) == 43
    x = _points(rng, b=2, n=256)
    ref = jm.apply(tree, jnp.asarray(x), train=False)
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_flax_like_init_statistics():
    """lecun_normal: each Dense kernel's spread is sqrt(1 / fan_in),
    truncated at 2 standard deviations; biases 0."""
    tm = tsn.SplineNet(grid=GRID, k=K, mode=0)
    tsn.init_flax_like(tm, torch.Generator().manual_seed(0))
    w = tm.conv6.weight.detach()
    np.testing.assert_allclose(float(w.std()), (1 / 1024) ** 0.5, rtol=0.02)
    assert float(w.abs().max()) <= 2 * (1 / 1024) ** 0.5 / 0.8796 + 1e-6
    assert float(tm.conv6.bias.abs().max()) == 0.0
    assert torch.equal(tm.bn5.running_var, torch.ones(1024))


def test_load_splinenet_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsn.load_splinenet("params/open_splinenet.npz", 0)
