"""Port parity: data/prefetch.py against parsenet_tpu/data/prefetch.py,
and the trainers' use of `lookahead`.

The same generator through both packages' functions: the same batches in
the same order, ending where the generator ends; prefetch_to_device on the
CPU gives each array as a tensor of the same values (the JAX side's
device_put arrays), None passing through. The card's path (pinned memory,
a side stream, the consumer's stream waiting on an event) is driven by
chip_smoke.py phase 9, which holds its batches equal and in order.
"""
import threading

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.core.config import Config
from parsenet_tpu_torch.data import prefetch as tpre
from parsenet_tpu_torch.data import splines as tspl
from parsenet_tpu_torch.data.synthetic import make_spline_batch
from parsenet_tpu_torch.train import train_spline as tts

torch.set_num_threads(1)


def _batches(n=7, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield (rng.randn(3, 4).astype(np.float32), np.full(2, i), None)


@pytest.mark.parametrize("size", [1, 2, 5])
def test_lookahead_matches_jax(size):
    from parsenet_tpu.data.prefetch import lookahead as j_lookahead
    want = list(j_lookahead(_batches(), size))
    got = list(tpre.lookahead(_batches(), size))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] is None and w[2] is None


def test_lookahead_runs_ahead_in_a_thread_and_raises_its_errors():
    seen = []

    def gen():
        for i in range(4):
            seen.append(threading.current_thread() is threading.main_thread())
            yield i
        raise RuntimeError("producer failed")

    it = tpre.lookahead(gen(), 2)
    assert next(it) == 0
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)
    assert seen and not any(seen)


def test_prefetch_to_device_on_the_cpu_matches_jax():
    import jax
    from parsenet_tpu.data.prefetch import prefetch_to_device as j_prefetch
    want = list(j_prefetch(_batches(), 2))
    got = list(tpre.prefetch_to_device(_batches(), 2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tuple) and torch.is_tensor(g[0])
        assert g[0].device.type == "cpu" and g[2] is None
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
        assert isinstance(w[0], jax.Array)


def test_prefetch_to_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.prefetch_to_device(_batches(), 2)


def test_trainers_wrap_the_training_generator_in_lookahead(tmp_path,
                                                           monkeypatch):
    """run_training reads its training batches through lookahead (the JAX
    trainers' train_gen = lookahead(train_gen)); the segmentation and e2e
    trainers call the same function in their loops."""
    from parsenet_tpu_torch.train import train_e2e, train_seg
    calls = []

    def spy(it, size=2):
        calls.append(size)
        return tpre.lookahead(it, size)

    monkeypatch.setattr(tts, "lookahead", spy)

    def gen(seed):
        rng = np.random.RandomState(seed)
        while True:
            pts, cps = make_spline_batch(rng, 2, 64, 6, False)
            yield tspl.canon_batch(pts, cps, False, True)

    cfg = Config(model_path="la", batch_size=2, grid_size=6, num_epochs=1,
                 log_dir=str(tmp_path))
    res = tts.run_training(cfg, train_gen=gen(1), val_gen=gen(2),
                           steps_per_epoch=2, val_steps=1,
                           point_buckets=(64,), checkpoint=False,
                           device="cpu")
    assert calls == [2] and len(res.steps) == 2
    for mod in (train_seg, train_e2e):
        assert mod.lookahead is tpre.lookahead
