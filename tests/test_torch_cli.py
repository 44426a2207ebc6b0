"""Port parity: the test-time entry points (parsenet_tpu_torch.cli) and the
mode-0 predict_segmentation.

generate_predictions' split function on 2 synthetic shapes x 1,024 points
with the shipped params (the bandwidth subset is the whole cloud
at N <= 5,000, so no draw is shared) against the JAX package's
predict_segmentation: canonical labels and types equal, seg / prim IoU
within 1e-4 (as test_torch_slice). test's split function with the draws
root test.py makes (jax.random) against the JAX package's reconstruct_shape
and, with --optimize, against test.py's refit loop over the JAX package's
host components: residual within 1e-3 relative, p_cov, sk_1 and sk_2
within 1e-3 (with --optimize, sk_1 and sk_2 on the JAX package's own
surfaces: see the test). Then the CLIs' main through a tiny ABC-format
h5, reading the checkpoint the port's trainer wrote.
"""
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu import cpp as jnative
from parsenet_tpu.core.checkpoint import load_npz_params as jax_load_npz
from parsenet_tpu.data.abc import normalize_points
from parsenet_tpu.data.synthetic import make_shape_batch, write_abc_h5
from parsenet_tpu.eval import pipeline as jp
from parsenet_tpu.models.dgcnn import PrimitivesEmbedding as JaxEmbedding
from parsenet_tpu.postprocess import optimize_spline_kronecker
from parsenet_tpu_torch.cli import generate_predictions as cgen
from parsenet_tpu_torch.cli import test as ctest
from parsenet_tpu_torch.core.checkpoint import unflatten_tree
from parsenet_tpu_torch.core.config import Config
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.models.dgcnn import (PrimitivesEmbedding,
                                             init_flax_like,
                                             load_primitives_embedding,
                                             params_to_jax)
from parsenet_tpu_torch.train import train_seg as tseg
from test_torch_slice import canonical
from test_torch_spline_slots import _staged_inputs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "params", "parsenet_e2e.npz")
N, B, SEED = 1024, 2, 3


def _stream(seed=13):
    """2 shapes of make_shape_batch at 1,024 points, normalised as bench.py
    does. Seed 13, as test_torch_dgcnn: on seed 7's second shape a
    layer-2 neighbour of the DGCNN sits 2e-6 (relative) from the 80th, so
    last-bit differences swap it (the exact top-k ties of ROADMAP section
    3), the global max-pool carries the swap to every point, and two points
    change cluster."""
    pts, lab, nrm, prim = make_shape_batch(np.random.RandomState(seed), B, N)
    for i in range(B):
        pts[i], nrm[i], _, _ = normalize_points(pts[i], nrm[i])
    return pts.astype(np.float32), lab, nrm.astype(np.float32), prim


def _jax_predictions(apply_fn, xs, lab, prim):
    """predict_segmentation of the JAX package as the root
    generate_predictions.py runs it, one key a shape split from
    PRNGKey(SEED)."""
    key, out = jax.random.PRNGKey(SEED), []
    for i in range(len(xs)):
        key, sub = jax.random.split(key)
        out.append(jp.predict_segmentation(apply_fn, jnp.asarray(xs[i]),
                                           jnp.asarray(lab[i]),
                                           jnp.asarray(prim[i]), sub))
    return out


def _assert_predictions_match(got, ref):
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(canonical(got["seg_id"][i]),
                                      canonical(r.labels))
        np.testing.assert_array_equal(got["pred_primitives"][i],
                                      np.asarray(r.pred_prim))
        assert got["num_clusters"][i] == int(r.num_clusters)
        np.testing.assert_allclose(got["seg_iou"][i], float(r.seg_iou),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["prim_iou"][i], float(r.prim_iou),
                                   rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def predicted():
    pts, lab, nrm, prim = _stream()
    jmodel = JaxEmbedding(emb_size=128, num_primitives=10, mode=5, k=80)
    jparams = jax_load_npz(PARAMS)["params"]
    apply_fn = jax.jit(lambda x: jmodel.apply({"params": jparams}, x))
    ref = _jax_predictions(apply_fn, np.concatenate([pts, nrm], -1), lab,
                           prim)
    model = load_primitives_embedding(PARAMS, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    got = cgen.predict_split(model, pts, nrm, lab, prim, gen, device="cpu")
    return (pts, lab, nrm, prim), model, ref, got


def test_predict_split_matches_jax(predicted):
    _, _, ref, got = predicted
    assert got["seg_id"].shape == (B, N) and got["seg_id"].dtype == np.int32
    assert got["pred_primitives"].dtype == np.int32
    _assert_predictions_match(got, ref)


def test_predict_split_drops_the_padding(predicted):
    """The tail batch of 2 padded to 4 by repetition gives what the 2
    shapes give alone, and the padding's results are dropped."""
    (pts, lab, nrm, prim), model, _, got = predicted
    alone = tp.predict_segmentation(model, pts, nrm, lab, prim,
                                    device="cpu")
    for i in range(B):
        np.testing.assert_array_equal(canonical(got["seg_id"][i]),
                                      canonical(alone.labels[i].numpy()))
        np.testing.assert_allclose(got["seg_iou"][i],
                                   float(alone.seg_iou[i]), rtol=0,
                                   atol=1e-6)
    assert len(got["seg_iou"]) == B


def test_mode0_predict_segmentation_matches_jax():
    """A mode-0 network (xyz only, as configs/config_parsenet.yml) through
    predict_segmentation: the port feeds it the points alone, as the JAX
    entry point does."""
    pts, lab, nrm, prim = _stream(seed=7)   # no near-tie at k = 16 here
    model = PrimitivesEmbedding(mode=0, k=16)
    init_flax_like(model, torch.Generator().manual_seed(5))
    model.eval()
    jmodel = JaxEmbedding(emb_size=128, num_primitives=10, mode=0, k=16)
    jparams = unflatten_tree(params_to_jax(model))["params"]
    apply_fn = jax.jit(lambda x: jmodel.apply({"params": jparams}, x))
    ref = _jax_predictions(apply_fn, pts, lab, prim)
    got = tp.predict_segmentation(model, pts, nrm, lab, prim, device="cpu")
    for i, r in enumerate(ref):
        np.testing.assert_allclose(got.embedding[i].numpy(),
                                   np.asarray(r.embedding), rtol=0,
                                   atol=1e-4)
    _assert_predictions_match(
        {"seg_id": got.labels.numpy(),
         "pred_primitives": got.pred_prim.numpy(),
         "num_clusters": got.num_clusters, "seg_iou": got.seg_iou.numpy(),
         "prim_iou": got.prim_iou.numpy()}, ref)


def _test_py_draws(n_shapes):
    """The keys of the root test.py: one split from PRNGKey(SEED) a shape;
    the coverage uniforms are reconstruct_shape's (fold_in 7)."""
    key, subs = jax.random.PRNGKey(SEED), []
    for _ in range(n_shapes):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs, [(torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(s, 7), (jp.COV_SAMPLES,)))), None) for s in subs]


def _assert_metrics_match(got, ref):
    for i, r in enumerate(ref):
        np.testing.assert_allclose(got["residual"][i], r["residual"],
                                   rtol=1e-3)
        for k in ("p_cov", "sk_1", "sk_2"):
            np.testing.assert_allclose(got[k][i], r[k], rtol=0, atol=1e-3)


def test_evaluate_split_matches_jax(predicted):
    (pts, _, nrm, _), _, ref_pred, _ = predicted
    labels = np.stack([np.asarray(r.labels) for r in ref_pred])
    prims = np.stack([np.asarray(r.pred_prim) for r in ref_pred])
    subs, draws = _test_py_draws(B)
    ref = []
    for i in range(B):
        rec = jp.reconstruct_shape(jnp.asarray(pts[i]), jnp.asarray(nrm[i]),
                                   jnp.asarray(labels[i]),
                                   jnp.asarray(prims[i]), subs[i],
                                   spline_fit=None)
        ref.append({k: float(getattr(rec, k)) for k in ctest.METRICS})
    got = ctest.evaluate_split(pts, nrm, labels, prims, None, draws=draws,
                               render_shapes=1, device="cpu")
    _assert_metrics_match(got, ref)
    assert len(got["meshes"]) == 1 and got["meshes"][0]


def _jax_refit_coverage(points, labels, prim, rec, key):
    """The --optimize block of the root test.py (lines 60-103), over the
    JAX package's host components and protocol_coverage."""
    surf = np.array(rec.surface_points)
    w = np.array(rec.area_weights)
    mask = np.asarray(rec.surface_mask).astype(bool)
    prim_remap = prim.copy()
    for v in (0, 6, 7):
        prim_remap[prim_remap == v] = 9
    prim_remap[prim_remap == 8] = 2
    g = int(round(surf.shape[1] ** 0.5))
    refit = 0
    for k in np.where(mask)[0]:
        seg_pts = points[labels == k]
        if len(seg_pts) <= 200:
            continue
        seg_prim = np.bincount(prim_remap[labels == k], minlength=10).argmax()
        if seg_prim not in (2, 9):
            continue
        seg_pts = jnative.remove_outliers(seg_pts.astype(np.float32))
        sub32 = surf[k].reshape(g, g, 3)[::g // 32, ::g // 32]
        surf[k] = optimize_spline_kronecker(
            sub32.reshape(-1, 3), seg_pts, closed=bool(seg_prim == 9),
            grid_u=32, grid_v=32, eval_grid=(g, g))
        s3 = surf[k].reshape(g, g, 3)
        tu = np.gradient(s3, axis=0)
        tv = np.gradient(s3, axis=1)
        w[k] = np.linalg.norm(np.cross(tu, tv), axis=-1).reshape(-1)
        refit += 1
    fw = (mask[:, None] * w).reshape(-1).astype(np.float32)
    c, s1, s2 = jp.protocol_coverage(jnp.asarray(points),
                                     jnp.asarray(surf.reshape(-1, 3)),
                                     jnp.asarray(fw), key)
    return {"residual": float(rec.residual), "p_cov": float(c),
            "sk_1": float(s1), "sk_2": float(s2)}, refit, surf


def test_evaluate_split_optimize_matches_jax():
    """--optimize on the staged shape of test_torch_spline_slots whose two
    spline segments (one open, one closed, 529 points each) are refit. On
    the JAX package's own reconstruction the refit equals test.py's to
    1e-5 and its coverage comes within 1e-3. End to end the residual and
    p_cov are held as above; sk_1 and sk_2 are not: the refit's LAP turns
    the ~1e-7 difference of a fallback surface into up to 7e-4 on a refit
    one (measured), which moves sk_1 by 12 of the 2,048 points."""
    pts, nrm, labels, prim = (a[1:] for a in _staged_inputs())
    subs, draws = _test_py_draws(1)
    rec = jp.reconstruct_shape(jnp.asarray(pts[0]), jnp.asarray(nrm[0]),
                               jnp.asarray(labels[0]), jnp.asarray(prim[0]),
                               subs[0], spline_fit=None)
    ref, refit, ref_surf = _jax_refit_coverage(pts[0], labels[0], prim[0],
                                               rec, subs[0])
    assert refit == 2
    mask = np.asarray(rec.surface_mask).astype(bool)
    surf, w = ctest.refine_splines(pts[0], labels[0], prim[0],
                                   np.array(rec.surface_points),
                                   np.array(rec.area_weights), mask)
    np.testing.assert_allclose(surf[mask], ref_surf[mask], rtol=0,
                               atol=1e-5)
    cov = tp.protocol_coverage(
        torch.from_numpy(pts[0]), torch.from_numpy(surf.reshape(-1, 3)),
        torch.from_numpy((mask[:, None] * w).reshape(-1).astype(np.float32)),
        draws[0][0])
    for k, c in zip(("p_cov", "sk_1", "sk_2"), cov):
        np.testing.assert_allclose(float(c), ref[k], rtol=0, atol=1e-3)
    got = ctest.evaluate_split(pts, nrm, labels, prim, None, draws=draws,
                               if_optimize=True, device="cpu")
    np.testing.assert_allclose(got["residual"][0], ref["residual"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["p_cov"][0], ref["p_cov"], rtol=0,
                               atol=1e-3)


def _write_config(path, **kw):
    with open(path, "w") as f:
        f.write("[train]\n" + "".join(
            f"{k} = {repr(v) if isinstance(v, str) else v}\n"
            for k, v in kw.items()).replace("'", '"'))
    return str(path)


def test_cli_mains_through_h5_from_the_trainers_checkpoint(tmp_path):
    """train_seg writes {log_dir}/checkpoints/seg.npz from a tiny ABC h5;
    cli.generate_predictions reads it and writes predictions.h5 in the
    layout the root test.py reads (seg_id and pred_primitives, [S, N]
    int32); cli.test reads that file and measures a shape."""
    prefix = str(tmp_path) + "/"
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        write_abc_h5(f"{prefix}{split}_data.h5", n, num_points=300,
                     seed=len(split))
    kw = dict(model_path="seg", dataset=prefix, num_train=4, num_val=2,
              num_test=2, batch_size=1, accum=2, mode=5, knn_k=4,
              num_epochs=1, lr=1e-3, log_dir=str(tmp_path / "logs"), seed=0)
    tseg.run_training(Config(**kw), steps_per_epoch=1, points_per_shape=256,
                      val_shapes=2, device="cpu")
    assert os.path.exists(tmp_path / "logs" / "checkpoints" / "seg.npz")
    cfg = _write_config(tmp_path / "cfg.yml", **kw)

    pred = cgen.main([cfg, "--device", "cpu"])
    # what the root test.py does with the file
    with h5py.File(tmp_path / "logs" / "predictions.h5", "r") as hf:
        assert sorted(hf.keys()) == ["pred_primitives", "seg_id"]
        seg_ids = np.array(hf.get("seg_id"))
        pred_prims = np.array(hf.get("pred_primitives"))
    assert seg_ids.shape == pred_prims.shape == (2, 300)
    assert seg_ids.dtype == pred_prims.dtype == np.int32
    np.testing.assert_array_equal(seg_ids, pred["seg_id"])
    np.testing.assert_array_equal(pred_prims, pred["pred_primitives"])

    out = ctest.main([cfg, "0", "1", "--device", "cpu"])
    assert all(len(out[k]) == 1 and np.isfinite(out[k][0])
               for k in ctest.METRICS)
    with pytest.raises(SystemExit):
        ctest.main([cfg, "--optimise", "--device", "cpu"])


def test_cli_without_checkpoint_names_the_export_script(tmp_path):
    cfg = Config(log_dir=str(tmp_path), model_path="absent")
    with pytest.raises(FileNotFoundError, match="scripts/export_params.py"):
        cgen.load_model(cfg, "cpu")
