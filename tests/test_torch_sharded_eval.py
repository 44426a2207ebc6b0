"""Port parity: eval/sharded.py, the BENCH_SHARD arm of cli/bench.py and
cli/dryrun_multichip.py.

* W = 2 gloo ranks (parallel.launch.spawn: spawn start method, a FileStore
  under tmp_path, one torch thread a rank, a 120 s deadline) against one
  rank: every per-shape metric bit for bit, and the all-reduced sums equal
  on both ranks. Each shape draws from its own generator, seeded from the
  batch seed and its global index, so a shape's numbers do not depend on
  the rank that runs it.
* Against the JAX package, with its per-shape draws handed to the port
  (ShapeDraws), the spline-free program on 2 shapes x 1,024 points with
  the shipped weights (k 80): the port's sums against the sums of the JAX
  package's per-shape program (eval/sharded.make_shape_pipeline, jitted a
  shape, the program its make_batched_eval vmaps over the mesh) within
  the end-to-end tolerances of tests/test_torch_slice.py times the shapes
  (seg_iou 1e-4 absolute, residual 1e-3 relative); as there, p_cov and
  sk_2 are not compared end to end: the coverage draw walks the segments
  in id order, and which point of a mode names its cluster rides on last
  bits (that test holds them on one numbering). The JAX package's make_batched_eval on make_mesh(2) is run
  and printed beside them: its vmapped batch clusters shape 0 of this
  input otherwise than its own per-shape program does (seg_iou 0.7674
  against 0.7947, where the port gives 0.7947), so it is not the
  yardstick of the port's per-shape program.
* The dry run at N = 2 on the CPU at 256 points and k 8, under the same
  deadline.
"""
import os

import numpy as np
import pytest
import torch

from parsenet_tpu_torch.cli import bench as tbench
from parsenet_tpu_torch.cli import dryrun_multichip as tdry
from parsenet_tpu_torch.data.synthetic import make_shape_batch
from parsenet_tpu_torch.eval import sharded as tsh
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             init_flax_like)
from parsenet_tpu_torch.parallel import launch

torch.set_num_threads(1)

DEADLINE = 120.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")


def _small_eval(mesh, batch, seed):
    """A small network (embedding 16, k 4, seeded) over `batch` on this
    rank's shapes -> (per-shape [B_local, 4], sums [4])."""
    model = PrimitivesEmbedding(emb_size=16, num_primitives=10, mode=5, k=4)
    init_flax_like(model, torch.Generator().manual_seed(0))
    model.eval()
    run = tsh.make_batched_eval(model, None, mesh, device="cpu",
                                ms_num_samples=128, ms_iterations=5)
    per = run.shape_metrics(*batch, seed=seed).numpy()
    return per, run(*batch, seed=seed).numpy()


def _batch():
    pts, labels, normals, prim = make_shape_batch(
        np.random.RandomState(3), 4, 256, min_segments=2, max_segments=4)
    return (pts.astype(np.float32), normals.astype(np.float32), labels,
            prim)


def test_two_ranks_give_one_ranks_metrics_bit_for_bit(tmp_path):
    batch = _batch()
    per1, sums1 = _small_eval(None, batch, 9)
    two = launch.spawn(_small_eval, 2, (batch, 9), device="cpu",
                       deadline=DEADLINE, store_dir=str(tmp_path))
    np.testing.assert_array_equal(np.concatenate([t[0] for t in two]), per1)
    np.testing.assert_array_equal(two[0][1], two[1][1])
    np.testing.assert_allclose(two[0][1], sums1, rtol=1e-6, atol=1e-7)
    assert np.isfinite(per1).all() and per1[:, 1].sum() > 0
    # another seed draws otherwise
    assert not np.array_equal(_small_eval(None, batch, 10)[0], per1)


def test_shape_seeds_depend_on_the_batch_seed_and_the_index():
    seeds = {tsh.shape_seed(s, i) for s in range(3) for i in range(4)}
    assert len(seeds) == 12
    assert tsh.shape_seed(1, 2) == tsh.shape_seed(1, 2)


def test_sums_match_the_jax_mesh_with_its_draws():
    import jax
    import jax.numpy as jnp
    from parsenet_tpu.core.checkpoint import load_npz_params as jax_load
    from parsenet_tpu.data.abc import normalize_points
    from parsenet_tpu.data.synthetic import make_shape_batch as j_batch
    from parsenet_tpu.eval import pipeline as jp
    from parsenet_tpu.eval.sharded import make_batched_eval as j_make
    from parsenet_tpu.eval.sharded import make_shape_pipeline as j_shape
    from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmb
    from parsenet_tpu.parallel.mesh import batch_sharding, make_mesh
    from parsenet_tpu_torch.models.dgcnn import load_primitives_embedding

    n, b, subset = 1024, 2, 512
    pts, lab, nrm, prim = j_batch(np.random.RandomState(7), b, n)
    for i in range(b):
        pts[i], nrm[i], _, _ = normalize_points(pts[i], nrm[i])
    pts, nrm = pts.astype(np.float32), nrm.astype(np.float32)
    jmodel = JaxEmb(emb_size=128, num_primitives=10, mode=5, k=80)
    jparams = jax_load(PARAMS)["params"]
    apply_fn = jax.jit(lambda x: jmodel.apply({"params": jparams}, x))
    mesh = make_mesh(2)
    bsh = batch_sharding(mesh)
    keys = jax.random.split(jax.random.PRNGKey(1), b)
    run = j_make(apply_fn, None, mesh=mesh, ms_num_samples=subset,
                 ms_iterations=50)
    sharded = np.asarray(run(*(jax.device_put(jnp.asarray(a), bsh)
                               for a in (pts, nrm, lab, prim)),
                             jax.device_put(keys, bsh)))
    one = jax.jit(j_shape(apply_fn, None, ms_num_samples=subset,
                          ms_iterations=50))
    want = np.zeros(4)
    for i in range(b):
        pred, rec = one(pts[i], nrm[i], lab[i], prim[i], keys[i])
        want += [float(rec.residual), float(pred.seg_iou),
                 float(rec.p_cov), float(rec.sk_2)]
    draws = []
    for key in keys:     # make_shape_pipeline's split, then each stage's
        k1, k2 = jax.random.split(key)
        draws.append(tsh.ShapeDraws(
            torch.from_numpy(np.asarray(
                jax.random.permutation(k1, n)[:subset])),
            torch.from_numpy(np.asarray(jax.random.uniform(
                jax.random.fold_in(k2, 7), (jp.COV_SAMPLES,))))))
    tmodel = load_primitives_embedding(PARAMS, device="cpu")
    got = tsh.make_batched_eval(tmodel, None, device="cpu",
                                ms_num_samples=subset)(
        pts, nrm, lab, prim, draws=draws).numpy()
    print("port", got, "JAX per shape", want, "JAX sharded", sharded)
    assert abs(got[1] - want[1]) <= b * 1e-4                      # seg_iou
    assert abs(got[0] - want[0]) <= 1e-3 * abs(want[0])           # residual
    assert np.isfinite(got).all()


def test_bench_shard_knobs():
    """BENCH_SHARD=1: BENCH_BATCH must divide by the ranks; with one rank
    it is the unsharded run."""
    with pytest.raises(ValueError, match="BENCH_BATCH"):
        tbench.settings({"BENCH_SHARD": "1", "WORLD_SIZE": "3"})
    assert tbench.settings({"BENCH_SHARD": "1", "WORLD_SIZE": "2"})["shard"]
    assert not tbench.settings({"BENCH_SHARD": "1"})["shard"]
    assert not tbench.settings({"WORLD_SIZE": "2"})["shard"]


def test_dryrun_two_ranks_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(tdry, "DEADLINE_S", DEADLINE)
    tdry.main(["2", "--device", "cpu", "--points", "256", "--k", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dryrun_multichip ok: {")
    assert out[1].startswith("dryrun_multichip inference ok: {")
    train, infer = tdry.dryrun(1, "cpu", 256, 8)
    assert train["grad_ok"] == 1.0
    assert all(np.isfinite(v) for v in {**train, **infer}.values())
    # the two-rank step is the one-rank step of the same batch of 1 shape
    # a rank: the metrics printed are finite and the inference sums exist
    assert set(infer) == {"residual", "seg_iou", "p_cov", "sk_2"}
