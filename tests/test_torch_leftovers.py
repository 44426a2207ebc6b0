"""Port parity: the last public library functions of the JAX package and
the h5 writers, against the JAX package on the same numpy inputs.

* core/guards.safe_acos, safe_normalize, masked_mean;
* ops/primitive_fits.fit_all_primitives (one segment) and
  fit_all_primitives_batched (segments with their own points);
* ops/primitive_dist.sqdist_torus, one torus and stacked over K;
* ops/knn.pairwise_sqdist and edge_features;
* ops/mean_shift.bandwidth_from_sorted;
* ops/hungarian.solve_lap_host: the same assignment;
* data/synthetic.write_abc_h5 and write_spline_h5: the same datasets,
  dtypes and values, bit for bit.

Tolerance 1e-5 relative, with an absolute floor where a value is zero in
exact arithmetic: 1e-6, and 1e-5 for the fits and the pairwise distances
(f32 sums of O(1) terms); fitted axes are compared up to sign, as
tests/test_torch_fits.py compares them.
"""
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.core import guards as jg
from parsenet_tpu.data import synthetic as jsyn
from parsenet_tpu.data.abc import normalize_points
from parsenet_tpu.data.synthetic import make_shape
from parsenet_tpu.ops import hungarian as jh
from parsenet_tpu.ops import knn as jknn
from parsenet_tpu.ops import mean_shift as jms
from parsenet_tpu.ops import primitive_dist as jpd
from parsenet_tpu.ops import primitive_fits as jpf
from parsenet_tpu_torch.core import guards as tg
from parsenet_tpu_torch.data import synthetic as tsyn
from parsenet_tpu_torch.ops import hungarian as th
from parsenet_tpu_torch.ops import knn as tknn
from parsenet_tpu_torch.ops import mean_shift as tms
from parsenet_tpu_torch.ops import primitive_dist as tpd
from parsenet_tpu_torch.ops import primitive_fits as tpf

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
def test_safe_acos_matches_jax(rng, eps):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 64),
                        [-1.0, 1.0, 0.0]]).astype(np.float32)
    close(tg.safe_acos(t(x), eps), jg.safe_acos(jnp.asarray(x), eps))


@pytest.mark.parametrize("axis", [-1, 0])
def test_safe_normalize_matches_jax(rng, axis):
    x = rng.randn(16, 3).astype(np.float32)
    x[3] = 0.0                                   # the guarded zero vector
    close(tg.safe_normalize(t(x), axis), jg.safe_normalize(jnp.asarray(x),
                                                           axis))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_masked_mean_matches_jax(rng, axis):
    x = rng.randn(8, 12).astype(np.float32)
    mask = rng.rand(8, 12) > 0.5
    mask[2] = False                              # an empty row
    close(tg.masked_mean(t(x), t(mask), axis),
          jg.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis))


def _segments():
    """The segments of one synthetic shape with at least 50 points, each
    as its own weighted cloud padded to a common length (weight 0 on the
    padding), and their types."""
    pts, lab, nrm, prim = make_shape(np.random.RandomState(3), 2048)
    pts, nrm, _, _ = normalize_points(pts, nrm)
    segs = [k for k in np.unique(lab) if np.sum(lab == k) >= 50]
    n = max(np.sum(lab == k) for k in segs)
    P = np.zeros((len(segs), n, 3), np.float32)
    N = np.zeros_like(P)
    W = np.zeros((len(segs), n), np.float32)
    for i, k in enumerate(segs):
        m = np.sum(lab == k)
        P[i, :m], N[i, :m], W[i, :m] = pts[lab == k], nrm[lab == k], 1.0
        P[i, m:], N[i, m:] = P[i, 0], N[i, 0]
    types = np.array([prim[lab == k][0] for k in segs])
    return P, N, W, types


def _close_params(got, ref, rows):
    """Each fit on the segments whose type it models; axes up to sign."""
    by_type = {"plane": (1,), "sphere": (5,), "cylinder": (4,), "cone": (3,)}
    for fit, labels in by_type.items():
        sel = np.flatnonzero(np.isin(rows, labels))
        for name, g, r in zip(getattr(ref, fit)._fields, getattr(got, fit),
                              getattr(ref, fit)):
            g, r = np.asarray(g)[sel], np.asarray(r)[sel]
            if name in ("normal", "axis"):
                g = g * np.sign(np.sum(g * r, axis=-1, keepdims=True))
            close(g, r, atol=1e-5)


def test_fit_all_primitives_matches_jax():
    P, N, W, types = _segments()
    assert set(types) >= {1, 4, 5}, types
    batched = tpf.fit_all_primitives_batched(t(P), t(N), t(W))
    ref_b = jpf.fit_all_primitives_batched(jnp.asarray(P), jnp.asarray(N),
                                           jnp.asarray(W))
    _close_params(batched, ref_b, types)
    for i in range(len(types)):
        one = tpf.fit_all_primitives(t(P[i]), t(N[i]), t(W[i]))
        ref = jpf.fit_all_primitives(jnp.asarray(P[i]), jnp.asarray(N[i]),
                                     jnp.asarray(W[i]))
        _close_params(*(jax.tree_util.tree_map(
            lambda a: np.asarray(a)[None], p) for p in (one, ref)),
            types[i:i + 1])


def test_sqdist_torus_matches_jax(rng):
    pts = rng.randn(300, 3).astype(np.float32)
    axis = rng.randn(4, 3).astype(np.float32)
    center = 0.3 * rng.randn(4, 3).astype(np.float32)
    big = rng.uniform(0.5, 1.0, 4).astype(np.float32)
    small = rng.uniform(0.05, 0.3, 4).astype(np.float32)
    stacked = tpd.sqdist_torus(t(pts), t(axis), t(center), t(big), t(small))
    assert stacked.shape == (4, 300)
    for k in range(4):
        ref = jpd.sqdist_torus(jnp.asarray(pts), jnp.asarray(axis[k]),
                               jnp.asarray(center[k]), float(big[k]),
                               float(small[k]))
        close(stacked[k], ref)
        close(tpd.sqdist_torus(t(pts), t(axis[k]), t(center[k]),
                               float(big[k]), float(small[k])), ref)


def test_pairwise_sqdist_matches_jax(rng):
    q = rng.randn(70, 6).astype(np.float32)
    x = rng.randn(90, 6).astype(np.float32)
    close(tknn.pairwise_sqdist(t(q), t(x)),
          jknn.pairwise_sqdist(jnp.asarray(q), jnp.asarray(x)), atol=1e-5)


def test_edge_features_match_jax(rng):
    x = rng.randn(2, 40, 5).astype(np.float32)
    idx = rng.randint(0, 40, (2, 40, 6)).astype(np.int32)
    got = tknn.edge_features(t(x), t(idx).long())
    assert got.shape == (2, 40, 6, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jknn.edge_features(jnp.asarray(x), jnp.asarray(idx))))


@pytest.mark.parametrize("quantile", [0.015, 0.025, 0.2, 1e-4, 0.9999])
def test_bandwidth_from_sorted_matches_jax(rng, quantile):
    x = rng.randn(300, 8)
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    d = np.sort(np.maximum(2.0 - 2.0 * x @ x.T, 0.0), axis=1)
    d = d.astype(np.float32)
    close(tms.bandwidth_from_sorted(t(d), quantile),
          jms.bandwidth_from_sorted(jnp.asarray(d), jnp.float32(quantile)))


@pytest.mark.parametrize("shape", [(7, 7), (5, 9), (9, 5)])
def test_solve_lap_host_matches_jax(rng, shape):
    cost = rng.rand(*shape).astype(np.float32)
    rows, cols = th.solve_lap_host(cost)
    ref_r, ref_c = jh.solve_lap_host(cost)
    assert rows.dtype == cols.dtype == np.int32
    np.testing.assert_array_equal(rows, ref_r)
    np.testing.assert_array_equal(cols, ref_c)


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, np.array(f[k])) for k in f}


def _same_h5(a, b):
    ha, hb = _h5(a), _h5(b)
    assert sorted(ha) == sorted(hb)
    for k in ha:
        assert ha[k][0] == hb[k][0], k
        np.testing.assert_array_equal(ha[k][1], hb[k][1])


def test_write_abc_h5_matches_jax(tmp_path):
    tsyn.write_abc_h5(str(tmp_path / "port" / "test_data.h5"), 3,
                      num_points=512, seed=2)
    jsyn.write_abc_h5(str(tmp_path / "jax" / "test_data.h5"), 3,
                      num_points=512, seed=2)
    _same_h5(tmp_path / "port" / "test_data.h5",
             tmp_path / "jax" / "test_data.h5")
    assert sorted(_h5(tmp_path / "port" / "test_data.h5")) == [
        "labels", "normals", "points", "prim"]


@pytest.mark.parametrize("closed", [False, True])
def test_write_spline_h5_matches_jax(tmp_path, closed):
    for pkg, mod in (("port", tsyn), ("jax", jsyn)):
        mod.write_spline_h5(str(tmp_path / pkg / "splines.h5"), 4,
                            num_points=100, grid=8, closed=closed,
                            seed=3 + closed)
    _same_h5(tmp_path / "port" / "splines.h5", tmp_path / "jax" / "splines.h5")
