"""The closed SplineNet's fed training step (train/train_spline.
make_fed_step over data/splines.SplineDataset.from_arrays) against the
benchmark's plain reference (benchmark/reference/train_spline.py) on the
CPU: the published widths (EdgeConvs 128/256/256/512, k 10, conv5 1,024,
a 20 x 20 grid), 4 patches a step of 256 points kept to 128 or 192, three
steps from a seeded init_flax_like. And run_training's steps are the fed
step's."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.patches import PatchPool
from benchmark.reference import compare
from benchmark.reference import train_spline as ref_spline
from parsenet_tpu_torch.core.config import Config
from parsenet_tpu_torch.data.splines import SplineDataset
from parsenet_tpu_torch.train import train_spline as tts

CPU = torch.device("cpu")
BATCH, BUCKETS, STEPS = 4, (128, 192), 3
MIX = dict(points=256, closed=True, pool_shapes=12, pool_seed=1005)
# Tolerances, the port's number against the reference's. Both run the
# same float32 operations on the CPU but for Adam (torch's against the one
# written out) and the chamfer (the port's plain K3 / K4 against the frozen
# copies): step 1's loss agrees to the bit and its gradient to 3e-8. Adam
# then moves the two models' weights apart by rounding (a gradient of
# rounding size has either sign, and Adam's first step moves its weight by
# lr whatever its size), and a near tie in a later step's kNN graphs or
# max-pool turns that into step 3's loss moving by up to 2.3e-3 and a
# leaf's change by up to 4.1e-3 (seven seed triples at these sizes).
# The reference with its dense products rounded to TF32 reads 5e-4 to
# 3.6e-3 on step 1's loss, 0.064 to 0.21 on the gradient and 0.027 to
# 0.050 on the worst leaf's change.
FIRST_LOSS_TOL = 1e-5   # step 1's loss, relative: the same operations
LOSS_TOL = 1e-2         # steps 2 and 3, relative: a near tie
GRAD_TOL = 1e-5         # the first gradient, the worst leaf's norm
CHANGE_TOL = 2e-2       # the three steps' change, the worst leaf's norm


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg() -> dict:
    return harness.load_json("configs", "splinenet_closed")


def port_steps(cfg, pool, data_seed, bucket_seed, init_seed) -> dict:
    """The port's first STEPS fed steps -> the numbers the check reads."""
    net, tr = cfg["network"], cfg["training"]
    grid = net["grid"]
    ds = SplineDataset.from_arrays(pool.points, pool.cps, BATCH, grid,
                                   closed=True, seed=data_seed,
                                   splits=(pool.size, 0))
    model, opt, train_step, _ = tts.make_trainer(
        Config(grid_size=grid, seed=init_seed, optim=tr["optimizer"],
               lr=tr["lr"]), net["mode"] == 1, tr["anisotropic"], CPU)
    fed = tts.make_fed_step(train_step, ds.load_train_data(if_augment=True),
                            np.random.RandomState(bucket_seed), BUCKETS, CPU)
    named = list(model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in named}
    beta1 = opt.param_groups[0]["betas"][0]
    losses, grad = [], {}
    for t in range(STEPS):
        losses.append(float(fed(tr["lr"], tr["loss_weight"])["loss"]))
        if t == 0:
            grad = {k: float(torch.linalg.norm(
                opt.state[p]["exp_avg"].double())) / (1.0 - beta1)
                for k, p in named}
    change = {k: float(torch.linalg.norm((p.detach() - p0[k]).double()))
              for k, p in named}
    return {"losses": losses, "grad": grad, "change": change}


def ref_steps(cfg, pool, data_seed, bucket_seed, init_seed) -> dict:
    batches = ref_spline.step_batches(pool, BATCH, STEPS, data_seed,
                                      bucket_seed, BUCKETS)
    return ref_spline.spline_steps(cfg, batches, init_seed, CPU)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32's 10-bit mantissa (to nearest, ties away); the
    gradient passes as through the identity."""
    i = t.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t.detach())


@contextlib.contextmanager
def tf32_products():
    """Every torch.nn.functional.linear with both operands rounded to TF32,
    as cuBLAS computes a float32 product with TF32 on."""
    linear = torch.nn.functional.linear

    def rounded(x, w, b=None):
        return linear(_tf32(x), _tf32(w), b)
    torch.nn.functional.linear = rounded
    try:
        yield
    finally:
        torch.nn.functional.linear = linear


def _gaps(prog, ref) -> dict:
    return compare.training_gaps(prog, ref)


SEEDS = [(11, 12, 13), (2 ** 31 + 1, 7, 2 ** 31 + 3)]


@pytest.mark.parametrize("seeds", SEEDS, ids=["small", "large"])
def test_fed_step_matches_the_reference(seeds):
    cfg, pool = _cfg(), PatchPool(MIX, 20)
    prog = port_steps(cfg, pool, *seeds)
    ref = ref_steps(cfg, pool, *seeds)
    gaps = _gaps(prog, ref)
    assert gaps["first_loss_gap"] <= FIRST_LOSS_TOL, gaps
    assert gaps["loss_gap"] <= LOSS_TOL, (gaps, prog["losses"],
                                          ref["losses"])
    assert gaps["grad_gap"] <= GRAD_TOL, gaps
    assert gaps["change_gap"] <= CHANGE_TOL, gaps
    # the steps train: three distinct losses and every leaf counted moves
    assert len(set(prog["losses"])) == STEPS
    assert min(prog["change"][k] for k in compare.leaves_counted(
        ref["grad"])) > 0


def test_tolerances_catch_products_one_precision_lower():
    cfg, pool = _cfg(), PatchPool(MIX, 20)
    ref = ref_steps(cfg, pool, *SEEDS[0])
    with tf32_products():
        low = ref_steps(cfg, pool, *SEEDS[0])
    gaps = _gaps(low, ref)
    assert (gaps["first_loss_gap"] > FIRST_LOSS_TOL
            or gaps["loss_gap"] > LOSS_TOL or gaps["grad_gap"] > GRAD_TOL
            or gaps["change_gap"] > CHANGE_TOL), gaps


def test_run_training_steps_are_the_fed_steps(monkeypatch, tmp_path):
    """run_training's loop through make_fed_step, against the fed step
    called in turn on the same feed and seed: the same point counts, step
    for step (those the fed step records in `drawn` too), and the same
    metrics, bit for bit."""
    cfg, pool = _cfg(), PatchPool(MIX, 20)
    seen = []
    make = tts.make_train_step

    def recording(*args, **kwargs):
        step, ev = make(*args, **kwargs)

        def train_step(points, *rest):
            seen[-1].append(points.shape[1])
            return step(points, *rest)
        return train_step, ev
    monkeypatch.setattr(tts, "make_train_step", recording)

    def feed():
        return SplineDataset.from_arrays(
            pool.points, pool.cps, BATCH, 20, closed=True, seed=3,
            splits=(8, 4))

    config = Config(batch_size=BATCH, grid_size=20, lr=1e-3, num_epochs=1,
                    seed=4, loss_weight=0.9, model_path="closed_t",
                    log_dir=str(tmp_path))
    seen.append([])
    ds = feed()
    res = tts.run_training(config, closed=True,
                           train_gen=ds.load_train_data(if_augment=True),
                           val_gen=ds.load_val_data(), steps_per_epoch=4,
                           val_steps=1, point_buckets=BUCKETS,
                           checkpoint=False, device=CPU)
    seen.append([])
    drawn = []
    _, _, train_step, _ = tts.make_trainer(config, True, True, CPU)
    fed = tts.make_fed_step(train_step,
                            feed().load_train_data(if_augment=True),
                            np.random.RandomState(config.seed), BUCKETS, CPU,
                            drawn=drawn)
    steps = [{k: float(v) for k, v in fed(config.lr,
                                          config.loss_weight).items()}
             for _ in range(4)]
    assert seen[0] == seen[1] == drawn and set(seen[0]) == set(BUCKETS)
    assert res.steps == steps
