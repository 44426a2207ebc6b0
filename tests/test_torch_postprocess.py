"""Port parity: the host side (postprocess/, the native binding, the rest of
ops/bspline.py, data/features.py).

The same inputs, made from numpy seeds, through the JAX package's function
and the port's. Tolerances: the basis matrices, the UV grid and the feature
samples within 1e-6; fit_surface_kronecker within the f32 bound of its
normal equations (cond x eps_f32, see the test);
solve_dense the same assignment as the JAX binding and scipy's optimal
cost; remove_outliers the same points; arap_deform within 1e-5; meshing
and PLY exact; optimize_spline_kronecker within 1e-5.
"""
import builtins
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu import cpp as jnative
from parsenet_tpu.data import features as jfeat
from parsenet_tpu.ops import bspline as jbs
from parsenet_tpu.postprocess import meshing as jmesh
from parsenet_tpu.postprocess import splines as jspl
from parsenet_tpu.postprocess import viz as jviz
from parsenet_tpu_torch import cpp as tnative
from parsenet_tpu_torch.data import features as tfeat
from parsenet_tpu_torch.ops import bspline as tbs
from parsenet_tpu_torch.postprocess import meshing as tmesh
from parsenet_tpu_torch.postprocess import splines as tspl
from parsenet_tpu_torch.postprocess import viz as tviz

torch.set_num_threads(1)


def _grid_surface(g, rng, closed=False):
    """A smooth bumpy patch (or a tube) sampled on a g x g grid."""
    u, v = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g),
                       indexing="ij")
    if closed:
        a = 2 * np.pi * u
        p = np.stack([np.cos(a), np.sin(a), 2 * v - 1], -1)
    else:
        p = np.stack([u, v, 0.2 * np.sin(3 * u) * np.cos(2 * v)], -1)
    p = p + 0.01 * rng.randn(*p.shape)
    return p.reshape(-1, 3).astype(np.float32)


# ---- ops/bspline.py, the rest

@pytest.mark.parametrize("n_ctrl,degree", [(10, 3), (20, 3), (6, 2)])
def test_basis_matrix_at_matches_jax(n_ctrl, degree):
    t = np.random.RandomState(n_ctrl).rand(200)
    t[:2] = (0.0, 1.0)
    np.testing.assert_allclose(tbs.basis_matrix_at(t, n_ctrl, degree),
                               jbs.basis_matrix_at(t, n_ctrl, degree),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_ctrl", [2, 4, 9])
def test_bernstein_basis_matches_jax(n_ctrl):
    t = np.linspace(0, 1, 33)
    np.testing.assert_allclose(tbs.bernstein_basis(n_ctrl, t),
                               jbs.bernstein_basis(n_ctrl, t), rtol=0,
                               atol=1e-6)


def test_regular_parameterization_matches_jax():
    np.testing.assert_allclose(tbs.regular_parameterization(7, 5),
                               jbs.regular_parameterization(7, 5), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("grid,weighted", [("random", False),
                                            ("random", True),
                                            ("regular", False),
                                            ("regular", True)])
def test_fit_surface_kronecker_matches_jax(grid, weighted):
    """Both packages solve the normal equations in f32, so each lies within
    cond(AtA + lam I) x eps_f32 x max|c| of the float64 solution, and
    within twice that of the other. 1e-5 relative is below that bound for
    every cubic basis: at the regular 30 x 30 grid of a 10 x 10 refit
    (cond ~500) the two f32 solutions differ by about 2e-5, each about
    1.5e-5 from the float64 one."""
    rng = np.random.RandomState(3)
    n = 8 if grid == "random" else 10
    uv = (rng.rand(600, 2) if grid == "random"
          else tbs.regular_parameterization(30, 30).astype(np.float64))
    m = len(uv)
    nu = tbs.basis_matrix_at(uv[:, 0], n, 3)
    nv = tbs.basis_matrix_at(uv[:, 1], n, 3)
    pts = np.stack([uv[:, 0], uv[:, 1],
                    0.3 * np.sin(4 * uv[:, 0]) * uv[:, 1]], 1)
    pts = (pts + 0.005 * rng.randn(m, 3)).astype(np.float32)
    w = ((0.5 + rng.rand(m)) if weighted else np.ones(m)).astype(np.float32)
    ref = np.asarray(jbs.fit_surface_kronecker(
        jnp.asarray(nu), jnp.asarray(nv), jnp.asarray(pts), jnp.asarray(w)))
    got = tbs.fit_surface_kronecker(*map(torch.from_numpy, (nu, nv, pts, w)))
    assert got.shape == (n, n, 3) and got.dtype == torch.float32
    a = (nu[:, :, None].astype(np.float64) * nv[:, None, :]).reshape(m, -1)
    a = a * w[:, None]
    ata = a.T @ a + 1e-5 * np.eye(n * n)
    exact = np.linalg.solve(ata, a.T @ (pts * w[:, None])).reshape(n, n, 3)
    tol = np.linalg.cond(ata) * np.finfo(np.float32).eps * np.abs(exact).max()
    assert np.abs(got.numpy() - exact).max() <= tol
    assert np.abs(ref - exact).max() <= tol
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2 * tol)


# ---- the native binding

@pytest.mark.parametrize("n", [1, 3, 17, 50, 128])
def test_solve_dense_matches_jax_binding_and_scipy(n):
    from scipy.optimize import linear_sum_assignment
    cost = np.random.RandomState(n).rand(n, n)
    r, c = tnative.solve_dense(cost)
    jr, jc = jnative.solve_dense(cost)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    rs, cs = linear_sum_assignment(cost)
    assert sorted(c.tolist()) == list(range(n))
    np.testing.assert_allclose(cost[r, c].sum(), cost[rs, cs].sum(),
                               rtol=0, atol=1e-9)


def test_solve_dense_on_ties():
    cost = np.ones((50, 50))
    cost[np.arange(5), np.arange(5)] = 0.0
    r, c = tnative.solve_dense(cost)
    np.testing.assert_array_equal(c, jnative.solve_dense(cost)[1])
    assert cost[r, c].sum() == 45.0


@pytest.mark.parametrize("k,ratio", [(20, 2.0), (8, 1.0)])
def test_remove_outliers_matches_jax_binding(k, ratio):
    rng = np.random.RandomState(k)
    pts = np.concatenate([rng.randn(400, 3).astype(np.float32) * 0.1,
                          np.float32([[9, 9, 9], [-9, 0, 0], [0, 3, 0]])])
    got = tnative.remove_outliers(pts, k, ratio)
    np.testing.assert_array_equal(got, jnative.remove_outliers(pts, k, ratio))
    assert len(got) < len(pts) and np.abs(got).max() < 3


def test_arap_deform_matches_jax_binding():
    g = 12
    verts = _grid_surface(g, np.random.RandomState(4))
    _, tris = tmesh.tessellate_grid(verts, g, g)
    hidx = np.array([0, g - 1, (g - 1) * g, g * g - 1, g * g // 2],
                    np.int32)
    hpos = verts[hidx].copy()
    hpos[3, 2] += 0.4
    hpos[4] += 0.1
    got = tnative.arap_deform(verts, tris, hidx, hpos, max_iter=20)
    ref = jnative.arap_deform(verts, tris, hidx, hpos, max_iter=20)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[hidx], hpos, atol=1e-3)


def test_native_sources_are_copies_and_a_failed_build_raises(monkeypatch,
                                                             tmp_path):
    """The port's C++ sources are the JAX package's, byte for byte (its
    own copies; test_torch_isolation checks that the build reads no other
    path); a failed g++ build raises."""
    for src in tnative.SOURCES:
        jsrc = os.path.join(os.path.dirname(jnative.__file__), src.name)
        assert src.read_bytes() == open(jsrc, "rb").read()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "CXX_FLAGS",
                        tnative.CXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.get_lib()
    assert not list(tmp_path.glob("*.so"))


# ---- postprocess/meshing.py and PLY

@pytest.mark.parametrize("wrap", [False, True])
def test_meshing_matches_jax_exactly(wrap, tmp_path):
    rng = np.random.RandomState(5)
    g = 9
    surf = _grid_surface(g, rng, closed=wrap)
    tv, tt = tmesh.tessellate_grid(surf, g, g, wrap_u=wrap)
    jv, jt = jmesh.tessellate_grid(surf, g, g, wrap_u=wrap)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    pts = surf[rng.rand(len(surf)) < 0.5]
    tt2 = tmesh.trim_mesh_by_distance(tv, tt, pts, 0.08, chunk=16)
    np.testing.assert_array_equal(
        tt2, jmesh.trim_mesh_by_distance(jv, jt, pts, 0.08, chunk=16))
    assert 0 < len(tt2) < len(tt)
    for a, b in zip(tmesh.remove_unreferenced(tv, tt2),
                    jmesh.remove_unreferenced(jv, tt2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmesh.sample_mesh(tv, tt, 300, seed=2),
                                  jmesh.sample_mesh(jv, jt, 300, seed=2))
    colors = rng.rand(len(tv), 3)
    for kw in ({}, {"triangles": tt}, {"triangles": tt, "colors": colors}):
        tmesh.write_ply(str(tmp_path / "t.ply"), tv, **kw)
        jmesh.write_ply(str(tmp_path / "j.ply"), jv, **kw)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
        rv, rt = tmesh.read_ply(str(tmp_path / "t.ply"))
        jrv, jrt = jmesh.read_ply(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(rv, jrv)
        if "triangles" in kw:
            np.testing.assert_array_equal(rt, jrt)
            np.testing.assert_array_equal(rt, tt)


# ---- postprocess/splines.py

def test_up_sample_points_in_range_matches_jax():
    pts = np.random.RandomState(6).rand(150, 3).astype(np.float32)
    for lo, hi in ((400, 500), (100, 120), (150, 150)):
        np.testing.assert_array_equal(
            tspl.up_sample_points_in_range(pts, lo, hi),
            jspl.up_sample_points_in_range(pts, lo, hi))
    np.testing.assert_array_equal(tspl.up_sample_points(pts, 2),
                                  jspl.up_sample_points(pts, 2))


@pytest.mark.parametrize("closed,deform", [(False, False), (True, False),
                                           (False, True)])
def test_optimize_spline_kronecker_matches_jax(closed, deform):
    rng = np.random.RandomState(7)
    g = 16
    surf = _grid_surface(g, rng, closed)
    inp = surf[rng.permutation(len(surf))[:200]] + 0.02 * rng.randn(200, 3)
    inp = inp.astype(np.float32)
    tris = tmesh.tessellate_grid(surf, g, g, wrap_u=closed)[1] \
        if deform else None
    kw = dict(closed=closed, grid_u=g, grid_v=g, deform=deform,
              triangles=tris, eval_grid=(12, 12))
    got = tspl.optimize_spline_kronecker(surf, inp, **kw)
    ref = jspl.optimize_spline_kronecker(surf, inp, **kw)
    assert got.shape == (144, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# ---- postprocess/viz.py

def test_viz_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    np.testing.assert_array_equal(tviz.random_pastel_colors(7),
                                  jviz.random_pastel_colors(7))
    labels = rng.randint(0, 60, 50)
    pts = rng.rand(50, 3).astype(np.float32)
    np.testing.assert_array_equal(tviz.colored_segmentation(pts, labels),
                                  jviz.colored_segmentation(pts, labels))
    shapes = [rng.rand(10, 3) for _ in range(7)]
    np.testing.assert_array_equal(tviz.grid_of_shapes(shapes, cols=3),
                                  jviz.grid_of_shapes(shapes, cols=3))
    tviz.save_segmentation_ply(str(tmp_path / "t.ply"), pts, labels)
    jviz.save_segmentation_ply(str(tmp_path / "j.ply"), pts, labels)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    tviz.save_xyz(str(tmp_path / "t.xyz"), pts, pts)
    jviz.save_xyz(str(tmp_path / "j.xyz"), pts, pts)
    assert (tmp_path / "t.xyz").read_bytes() == \
        (tmp_path / "j.xyz").read_bytes()
    np.testing.assert_allclose(tviz._view_matrix(), jviz._view_matrix(),
                               rtol=0, atol=0)


def test_render_without_matplotlib_returns_false(monkeypatch, tmp_path):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    v, t = tmesh.tessellate_grid(_grid_surface(4, np.random.RandomState(0)),
                                 4, 4)
    path = str(tmp_path / "grid.png")
    assert tviz.render_meshes_png(path, [(v, t, (0.5, 0.5, 0.5))]) is False
    assert tviz.render_reconstruction_grid(path, [[(v, t, 3)]]) is False
    assert tviz.scatter_png(path, v) is None
    assert not os.path.exists(path)


# ---- data/features.py

FEATURES = [
    {"type": "Plane", "location": [0.1, 0.2, 0.3], "axis": [0, 0, 1]},
    {"type": "plane", "location": [0, 0, 0], "x_axis": [1, 0, 0],
     "y_axis": [0, 1, 0], "z_axis": [0, 0, 1],
     "vert_parameters": [[-2, 0.5], [1, 3]]},
    {"type": "cylinder", "location": [0, 1, 0], "axis": [1, 1, 0],
     "radius": 0.7, "vert_parameters": [[0, -1], [1, 2]]},
    {"type": "sphere", "location": [1, 0, 0], "axis": [0, 1, 0],
     "radius": 1.3},
    {"type": "cone", "location": [0, 0, 0], "axis": [0, 0, 1],
     "radius": 0.2, "angle": 0.4},
    {"type": "torus", "location": [0, 0, 1], "axis": [0.9, 0.1, 0],
     "max_radius": 1.0, "min_radius": 0.25},
    {"type": "revolution"},
]


@pytest.mark.parametrize("i", range(len(FEATURES)))
def test_sample_feature_matches_jax(i):
    got = tfeat.sample_feature(FEATURES[i], grid=11)
    ref = jfeat.sample_feature(FEATURES[i], grid=11)
    if ref is None:
        assert got is None
        return
    assert got.shape == (121, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rational", [False, True])
def test_sample_spline_patch_matches_jax(rational):
    rng = np.random.RandomState(9)
    feat = {"type": "BSpline", "u_degree": 3, "v_degree": 2,
            "control_points": rng.rand(6, 5, 3),
            "u_knots": [0, 0, 0, 0, 0.3, 0.3, 1, 1, 1, 1],
            "v_knots": [0, 0, 0, 0.5, 0.7, 1, 1, 1]}
    if rational:
        feat["weights"] = 0.5 + rng.rand(6, 5)
    got = tfeat.sample_feature(feat, grid=9)
    np.testing.assert_allclose(got, jfeat.sample_feature(feat, grid=9),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tfeat.sample_spline_patch(feat, 9), got,
                               rtol=0, atol=0)
