"""Port parity: 3x3 eigensolver, primitive fits, residuals and surface
samplers against the JAX package.

Tolerance: rtol 1e-4 with an absolute floor of 1e-5 for components that
are zero in exact arithmetic; axes are compared up to sign. Each fit is
held on the segments of its own type (a plane fit to a full sphere has no
defined normal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsenet_tpu.data.abc import normalize_points
from parsenet_tpu.data.synthetic import make_shape
from parsenet_tpu.ops import linalg as jla
from parsenet_tpu.ops import primitive_dist as jpd
from parsenet_tpu.ops import primitive_fits as jpf
from parsenet_tpu.ops import sampling as jsm
from parsenet_tpu_torch.core.guards import EPS
from parsenet_tpu_torch.ops import linalg as tla
from parsenet_tpu_torch.ops import primitive_dist as tpd
from parsenet_tpu_torch.ops import primitive_fits as tpf
from parsenet_tpu_torch.ops import sampling as tsm

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
K = 50


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def close_up_to_sign(a, b):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    close(a * s, b)


@pytest.fixture(scope="module")
def shape():
    pts, lab, nrm, prim = make_shape(np.random.RandomState(3), 2048)
    pts, nrm, _, _ = normalize_points(pts, nrm)
    pts, nrm = pts.astype(np.float32), nrm.astype(np.float32)
    oh = (lab[:, None] == np.arange(K)[None]).astype(np.float32)
    seg_type = np.zeros(K, np.int64)
    for k in range(K):
        if oh[:, k].sum():
            seg_type[k] = prim[lab == k][0]
    w = oh.T + np.float32(EPS)
    ref = jpf.fit_all_primitives_shared_points(jnp.asarray(pts),
                                               jnp.asarray(nrm),
                                               jnp.asarray(w))
    got = tpf.fit_all_primitives_shared_points(torch.from_numpy(pts),
                                               torch.from_numpy(nrm),
                                               torch.from_numpy(w))
    return dict(pts=pts, nrm=nrm, oh=oh, seg_type=seg_type, ref=ref, got=got)


def _of_type(shape, label):
    sel = np.flatnonzero((shape["seg_type"] == label)
                         & (shape["oh"].sum(0) >= 20))
    if sel.size == 0:
        pytest.skip(f"shape has no segment of type {label}")
    return sel


def test_eigh3_matches_jax(rng):
    q, _ = np.linalg.qr(rng.randn(64, 3, 3))
    lam = np.sort(rng.rand(64, 3) * 3, axis=1) + np.arange(3) * 0.5
    A = (q * lam[:, None, :]) @ np.swapaxes(q, 1, 2)
    A = A.astype(np.float32)
    w_ref, v_ref = jla._jacobi_eigh3(jnp.asarray(A))
    w, v = tla.eigh3(torch.from_numpy(A))
    close(w.numpy(), w_ref)
    close_up_to_sign(np.swapaxes(v.numpy(), 1, 2), np.swapaxes(
        np.asarray(v_ref), 1, 2))
    close(tla.smallest_eigvec(torch.from_numpy(A)).numpy(),
          jla.smallest_eigvec(jnp.asarray(A)))


def test_ridge_lstsq_matches_jax(rng):
    A = rng.randn(8, 40, 3).astype(np.float32)
    y = rng.randn(8, 40, 1).astype(np.float32)
    close(tla.ridge_lstsq(torch.from_numpy(A), torch.from_numpy(y)).numpy(),
          jla.ridge_lstsq(jnp.asarray(A), jnp.asarray(y)))


def test_fit_plane(shape):
    sel = _of_type(shape, 1)
    close_up_to_sign(shape["got"].plane.normal[sel].numpy(),
                     np.asarray(shape["ref"].plane.normal)[sel])
    close(np.abs(shape["got"].plane.offset[sel].numpy()),
          np.abs(np.asarray(shape["ref"].plane.offset)[sel]))


def test_fit_sphere(shape):
    sel = _of_type(shape, 5)
    close(shape["got"].sphere.center[sel].numpy(),
          np.asarray(shape["ref"].sphere.center)[sel])
    close(shape["got"].sphere.radius[sel].numpy(),
          np.asarray(shape["ref"].sphere.radius)[sel])


def test_fit_cylinder(shape):
    sel = _of_type(shape, 4)
    got, ref = shape["got"].cylinder, shape["ref"].cylinder
    close_up_to_sign(got.axis[sel].numpy(), np.asarray(ref.axis)[sel])
    close(got.center[sel].numpy(), np.asarray(ref.center)[sel])
    close(got.radius[sel].numpy(), np.asarray(ref.radius)[sel])


def test_fit_cone(shape):
    sel = _of_type(shape, 3)
    got, ref = shape["got"].cone, shape["ref"].cone
    close(got.apex[sel].numpy(), np.asarray(ref.apex)[sel])
    close(got.axis[sel].numpy(), np.asarray(ref.axis)[sel])
    close(got.theta[sel].numpy(), np.asarray(ref.theta)[sel])


def test_residual_select(shape):
    geom = np.array(jpd.geom_type_from_label(jnp.asarray(shape["seg_type"])))
    np.testing.assert_array_equal(
        tpd.geom_type_from_label(torch.from_numpy(shape["seg_type"])).numpy(),
        geom)
    ref = np.asarray(jpd.residual_select(jnp.asarray(shape["pts"]),
                                         shape["ref"], jnp.asarray(geom)))
    # the same parameters on both sides, so only the distance maths differs
    params = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                    shape["ref"])
    params = tpf.AllPrimParams(*(type(p)(*v) for p, v in
                                 zip(shape["got"], params)))
    got = tpd.residual_select(torch.from_numpy(shape["pts"]), params,
                              torch.from_numpy(geom)).numpy()
    valid = shape["oh"].sum(0) >= 20
    close(got[valid], ref[valid])


@pytest.mark.parametrize("kind", ["plane", "sphere", "cylinder", "cone"])
def test_samplers(shape, kind):
    label = {"plane": 1, "sphere": 5, "cylinder": 4, "cone": 3}[kind]
    sel = _of_type(shape, label)
    p = getattr(shape["ref"], kind)
    pts, mask = shape["pts"], shape["oh"].T
    jfn = {"plane": jsm.sample_plane, "cylinder": jsm.sample_cylinder,
           "cone": jsm.sample_cone}
    if kind == "sphere":
        ref = jax.vmap(lambda c, r, m: jsm.sample_sphere(
            c, r, 64, seg_points=jnp.asarray(pts), seg_mask=m))(
            *p, jnp.asarray(mask))
    else:
        ref = jax.vmap(lambda *a: jfn[kind](*a[:-1], jnp.asarray(pts), a[-1],
                                            64))(*p, jnp.asarray(mask))
    tfn = {"plane": tsm.sample_plane, "sphere": tsm.sample_sphere,
           "cylinder": tsm.sample_cylinder, "cone": tsm.sample_cone}[kind]
    got = tfn(*(torch.from_numpy(np.array(a)) for a in p),
              torch.from_numpy(pts), torch.from_numpy(mask), 64)
    assert got.shape == (K, 64 * 64, 3)
    close(got.numpy()[sel], np.asarray(ref)[sel])
