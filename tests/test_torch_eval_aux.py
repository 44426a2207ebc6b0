"""Port parity: the rest of eval (metrics.py, save_params.py, splines.py,
pipeline.coverage_metrics) and core/profiling.py.

The same inputs, made from numpy seeds, through the JAX package's function
and the port's (the plain kernel versions on the CPU). Tolerances: the
numpy metrics exactly; coverage_metrics and iou_from_embeddings within
1e-4, canonical labels equal; save_params' h5 a bitwise round trip, its
dict equal to the JAX package's for the same fits, resampled surfaces and
exported meshes within 1e-5; evaluate_splinenet's cd within 1e-4 relative
on 2 batches of 4 patches from the shipped npz, cd_optim within 1e-4
relative, where a decoder's kNN breaks a near-tie otherwise than the JAX
package's: with the JAX package's kNN graphs.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core.checkpoint import load_npz_params as jax_load_npz
from parsenet_tpu.core.config import Config as JaxConfig
from parsenet_tpu.data.abc import normalize_points
from parsenet_tpu.data.synthetic import make_shape_batch
from parsenet_tpu.eval import metrics as jmetrics
from parsenet_tpu.eval import pipeline as jp
from parsenet_tpu.eval import save_params as jsave
from parsenet_tpu.eval import splines as jsplines
from parsenet_tpu.ops import primitive_fits as jfits
from parsenet_tpu_torch.core import profiling
from parsenet_tpu_torch.core.config import Config
from parsenet_tpu_torch.data.splines import synthetic_batches
from parsenet_tpu_torch.eval import metrics as tmetrics
from parsenet_tpu_torch.eval import pipeline as tp
from parsenet_tpu_torch.eval import save_params as tsave
from parsenet_tpu_torch.eval import splines as tsplines
from parsenet_tpu_torch.models.splinenet import load_splinenet
from parsenet_tpu_torch.ops import primitive_fits as tfits
from parsenet_tpu_torch.ops import knn as tknn
from test_torch_slice import canonical
from test_torch_spline_eval import _jax_graphs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- eval/metrics.py

def test_numpy_metrics_match_jax():
    rng = np.random.RandomState(0)
    pts = rng.rand(300, 3).astype(np.float32)
    surf = rng.rand(500, 3).astype(np.float32)
    for thr in (0.01, 0.05):
        assert tmetrics.p_coverage(pts, surf, thr) == \
            jmetrics.p_coverage(pts, surf, thr)
    dist = {0: 0.02, 1: 3.0, 2: None, 3: 0.05, 4: 0.01}
    types = {0: "plane", 1: "open-spline", 2: "cone", 3: "closed-spline",
             4: "sphere"}
    for lamb in (1.0, 0.5):
        assert tmetrics.separate_losses_np(dist, types, lamb) == \
            jmetrics.separate_losses_np(dist, types, lamb)
    assert tmetrics.separate_losses_np({}, {}) == \
        jmetrics.separate_losses_np({}, {})
    labels = rng.randint(0, 5, 300)
    labels[rng.rand(300) < 0.2] = 100
    np.testing.assert_array_equal(tmetrics.remove_unassigned(labels, pts),
                                  jmetrics.remove_unassigned(labels, pts))
    pred, gt = rng.randint(0, 6, 300), rng.randint(0, 6, 300)
    assert tmetrics.iou_one_sample(pred, gt, 6) == \
        jmetrics.iou_one_sample(pred, gt, 6)
    shapes = [{"name": i, "surfaces": [
        {"type": "Plane", "points": rng.rand(4, 3),
         "control_points": rng.rand(n, 3)} for n in range(1, 2 + i)]}
        for i in range(4)]
    for kw in ({}, {"max_surfaces": 2}, {"max_control_points": 2}):
        t, j = (m.compute_stats(shapes, **kw) for m in (tmetrics, jmetrics))
        assert [s["name"] for s in t] == [s["name"] for s in j]
        assert all("points" not in f for s in t for f in s["surfaces"])


@pytest.mark.parametrize("n,d", [(600, 16), (1024, 32)])
def test_iou_from_embeddings_matches_jax(n, d):
    rng = np.random.RandomState(n)
    gt = rng.randint(0, 6, n)
    centres = rng.randn(6, d)
    emb = (centres[gt] + 0.3 * rng.randn(n, d)).astype(np.float32)
    ref_iou, ref_labels = jmetrics.iou_from_embeddings(emb, gt)
    got_iou, got_labels = tmetrics.iou_from_embeddings(emb, gt,
                                                       device="cpu")
    np.testing.assert_array_equal(canonical(got_labels),
                                  canonical(ref_labels))
    np.testing.assert_allclose(got_iou, ref_iou, rtol=0, atol=1e-4)


def test_iou_from_embeddings_takes_its_draws():
    emb = np.random.RandomState(1).randn(5001, 4).astype(np.float32)
    with pytest.raises(ValueError, match="subset or a generator"):
        tmetrics.iou_from_embeddings(emb, np.zeros(5001, np.int64),
                                     device="cpu")


# ---- eval/pipeline.coverage_metrics

@pytest.mark.parametrize("masked,weighted", [(False, False), (True, False),
                                             (True, True)])
def test_coverage_metrics_matches_jax(masked, weighted):
    rng = np.random.RandomState(2)
    pts = rng.rand(700, 3).astype(np.float32)
    surf = (pts[rng.randint(0, 700, 1500)]
            + 0.02 * rng.randn(1500, 3)).astype(np.float32)
    mask = (rng.rand(1500) < 0.8 if masked else np.ones(1500)
            ).astype(np.float32)
    w = (mask * rng.rand(1500)).astype(np.float32) if weighted else None
    ref = jp.coverage_metrics(jnp.asarray(pts), jnp.asarray(surf),
                              jnp.asarray(mask),
                              None if w is None else jnp.asarray(w))
    got = tp.coverage_metrics(torch.from_numpy(pts), torch.from_numpy(surf),
                              torch.from_numpy(mask),
                              None if w is None else torch.from_numpy(w))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=0, atol=1e-4)


# ---- eval/save_params.py

@pytest.fixture(scope="module")
def fitted_shape():
    """One stream-a shape of 1,024 points fitted by the JAX package, its 4
    largest segments typed plane, sphere, cylinder and cone."""
    pts, lab, nrm, _ = make_shape_batch(np.random.RandomState(7), 1, 1024)
    pts, nrm, _, _ = normalize_points(pts[0], nrm[0])
    pts, nrm, lab = pts.astype(np.float32), nrm.astype(np.float32), lab[0]
    k = int(lab.max()) + 1
    w = (lab[None, :] == np.arange(k)[:, None]).astype(np.float32) + 1e-7
    jparams = jfits.fit_all_primitives_shared_points(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(w))
    order = np.argsort(-np.bincount(lab))
    geom = -np.ones(k, np.int32)
    geom[order[:4]] = np.arange(4)
    valid = geom >= 0
    tparams = tfits.AllPrimParams(*(
        cls(*(torch.from_numpy(np.array(x)) for x in part))
        for cls, part in zip((tfits.PlaneParams, tfits.SphereParams,
                              tfits.CylinderParams, tfits.ConeParams),
                             jparams)))
    return pts, lab, jparams, tparams, geom, valid


def test_params_to_dict_and_h5_match_jax(fitted_shape, tmp_path):
    _, _, jparams, tparams, geom, valid = fitted_shape
    surf = np.random.RandomState(3).rand(2, 16, 3).astype(np.float32)
    slots = np.array([1, 3])
    got = tsave.params_to_dict(tparams, geom, valid, torch.from_numpy(surf),
                               slots)
    ref = jsave.params_to_dict(jparams, geom, valid, surf, slots)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    tsave.save_h5(str(tmp_path / "t" / "shape.h5"), got)
    back = tsave.load_h5(str(tmp_path / "t" / "shape.h5"))
    jsave.save_h5(str(tmp_path / "j.h5"), ref)
    jback = tsave.load_h5(str(tmp_path / "j.h5"))
    for key in ref:
        np.testing.assert_array_equal(back[key], got[key])
        assert back[key].dtype == got[key].dtype
        np.testing.assert_array_equal(jback[key], back[key])
    assert sorted(jsave.load_h5(str(tmp_path / "t" / "shape.h5"))) == \
        sorted(back)


def test_resample_and_export_match_jax(fitted_shape, tmp_path):
    pts, lab, jparams, tparams, geom, valid = fitted_shape
    d = jsave.params_to_dict(jparams, geom, valid)
    for k in np.flatnonzero(valid):
        seg = pts[lab == k]
        np.testing.assert_allclose(
            tsave.resample_segment_surface(d, int(k), seg, 16),
            jsave.resample_segment_surface(d, int(k), seg, 16),
            rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not geometric"):
        tsave.resample_segment_surface(d, int(np.flatnonzero(~valid)[0]),
                                       pts, 16)
    got = tsave.export_shape_meshes(d, pts, lab, str(tmp_path / "t"),
                                    grid=24)
    ref = jsave.export_shape_meshes(d, pts, lab, str(tmp_path / "j"),
                                    grid=24)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref] and len(got) == 4
    from parsenet_tpu_torch.postprocess.meshing import read_ply
    for g, r in zip(got, ref):
        (gv, gt), (rv, rt) = read_ply(g), read_ply(r)
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-5)


# ---- core/profiling.py

def test_profiling_on_the_cpu(tmp_path):
    with profiling.capture_trace(str(tmp_path)) as prof:
        with profiling.trace("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "port_region" for e in prof.key_averages())
    (path,) = tmp_path.glob("trace_*.json")
    assert "port_region" in json.dumps(json.loads(path.read_text()))
    timer = profiling.StepTimer(skip_first=1)
    for _ in range(3):
        with timer.step("cpu"):
            torch.ones(8).sum()
    s = timer.summary()
    assert s["n"] == 2 and s["mean_s"] > 0 and s["p90_s"] >= s["p50_s"]
    stages = profiling.StageTimer(False)
    with stages("x"):
        pass
    assert stages.events == {}


# ---- eval/splines.py

def _patch_batches(closed, n_batches, batch):
    gen = synthetic_batches(np.random.RandomState(11), batch, 700, 20,
                            closed)
    return [next(gen) for _ in range(n_batches)]


def _within_or_knn_tie(run, ref, batches, closed, keys):
    """run() -> the port's result dict: each of `keys` within 1e-4
    relative of `ref`'s, or, where a decoder's exact top-k takes other
    neighbours than the JAX package's at a near-tie (the standing
    difference of the SplineNet kNN, test_torch_spline_eval), within 1e-4
    relative with the JAX package's kNN graphs forced into the port's
    decoder (printed)."""
    got = run()
    off = [k for k in keys if abs(got[k] - ref[k]) > 1e-4 * abs(ref[k])]
    if off:
        queue = [torch.from_numpy(g) for b in batches
                 for g in _jax_graphs(b[0], closed)[0]]
        real = tknn.knn
        tknn.knn = lambda x, k1, k2=None: queue.pop(0)
        try:
            forced = run()
        finally:
            tknn.knn = real
        assert not queue
        print(f"off by more than 1e-4: {[(k, got[k], ref[k]) for k in off]}"
              f"; on the JAX package's kNN graphs: "
              f"{[(k, forced[k]) for k in off]}")
        got = forced
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4)


@pytest.mark.parametrize("closed", [False, True])
def test_evaluate_splinenet_matches_jax(closed, tmp_path):
    name = "closed" if closed else "open"
    batches = _patch_batches(closed, 2, 4)
    ref = jsplines.evaluate_splinenet(
        JaxConfig(grid_size=20), closed=closed, test_gen=iter(batches),
        num_batches=2, variables=jax_load_npz(os.path.join(
            REPO, "params", f"{name}_splinenet.npz")))
    # the decoder from where the port's trainer saves it
    cfg = Config(grid_size=20, log_dir=str(tmp_path),
                 model_path=f"{name}_splinenet")
    os.makedirs(tmp_path / "checkpoints")
    with open(os.path.join(REPO, "params", f"{name}_splinenet.npz"),
              "rb") as f:
        (tmp_path / "checkpoints" / f"{name}_splinenet.npz").write_bytes(
            f.read())

    def run():
        out = tsplines.evaluate_splinenet(
            cfg, closed=closed, test_gen=iter(batches), num_batches=2,
            device="cpu")
        assert sorted(out) == ["cd"]
        return out
    _within_or_knn_tie(run, ref, batches, closed, ["cd"])


def test_evaluate_splinenet_refit_and_export_match_jax(tmp_path):
    batches = _patch_batches(False, 1, 2)
    path = os.path.join(REPO, "params", "open_splinenet.npz")
    ref = jsplines.evaluate_splinenet(
        JaxConfig(grid_size=20), test_gen=iter(batches), num_batches=1,
        variables=jax_load_npz(path), if_optimize=True,
        export_dir=str(tmp_path / "j"))
    model = load_splinenet(path, 0, device="cpu")
    _within_or_knn_tie(lambda: tsplines.evaluate_splinenet(
        Config(grid_size=20), test_gen=iter(batches), num_batches=1,
        model=model, if_optimize=True, export_dir=str(tmp_path / "t"),
        device="cpu"), ref, batches, False, ["cd", "cd_optim"])
    from parsenet_tpu_torch.postprocess.meshing import read_ply
    for f in ("pred_0_0.ply", "gt_0_0.ply", "pred_0_1.ply", "gt_0_1.ply"):
        (gv, gt), (rv, rt) = (read_ply(str(tmp_path / s / f))
                              for s in ("t", "j"))
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-4)


def test_evaluate_splinenet_without_checkpoint_raises(tmp_path):
    cfg = Config(log_dir=str(tmp_path), model_path="open_splinenet")
    with pytest.raises(FileNotFoundError, match="no SplineNet checkpoint"):
        tsplines.evaluate_splinenet(cfg, test_gen=iter([]), device="cpu")
