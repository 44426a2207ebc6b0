"""Port parity: parallel/mesh.py and parallel/ring.py against the JAX
package's mesh and ring on its 8-device CPU mesh.

The port's ranks are gloo processes spawned by parallel.launch.spawn (the
spawn start method, a FileStore under tmp_path, one torch thread a rank,
a 120 s deadline). The JAX side runs here, on make_mesh(W), and is handed
to the ranks' results as numpy. Ring tolerances: d within 1e-5 relative /
1e-6 absolute; indices equal to JAX's, ties included: integer coordinates
and duplicated targets make many distances exactly equal, and the first
shard visited wins a tie.
"""
import numpy as np
import pytest
import torch

from parsenet_tpu_torch.parallel import launch, mesh as tmesh, ring as tring

torch.set_num_threads(1)

DEADLINE = 120.0


def _tied_cloud(seed, n, m):
    """Integer coordinates (exact squared distances), the targets repeated
    in blocks so that equal distances straddle the shards."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, size=(n, 3)).astype(np.float32)
    base = rng.randint(-3, 4, size=(m // 4, 3)).astype(np.float32)
    x = np.concatenate([base, base[::-1], base, base[::-1]])
    return q, x


def _rank_ring(mesh, q, x, feats, k):
    """This rank's shards of the global q, x and feats through both ring
    ops, and the mesh layout at model_parallel 2 (where it divides)."""
    sl_q = tmesh.shard_slice(q.shape[0], mesh)
    sl_x = tmesh.shard_slice(x.shape[0], mesh)
    d, i = tring.ring_min_sqdist(mesh, torch.from_numpy(q[sl_q]),
                                 torch.from_numpy(x[sl_x]))
    nb = tring.ring_knn(mesh, torch.from_numpy(
        feats[tmesh.shard_slice(feats.shape[0], mesh)]), k)
    layout = None
    if mesh.world % 2 == 0:
        m2 = tmesh.make_mesh(mesh.world, model_parallel=2, device="cpu")
        rows = tmesh.shard_batch(m2, torch.arange(mesh.world))
        layout = (m2.shape, m2.data_index, rows.tolist())
    return d.numpy(), i.numpy(), nb.numpy(), layout


def _jax_ring(world, q, x, feats, k):
    from parsenet_tpu.parallel.mesh import make_mesh
    from parsenet_tpu.parallel.ring import ring_knn, ring_min_sqdist
    m = make_mesh(world)
    d, i = ring_min_sqdist(m, q, x)
    return np.asarray(d), np.asarray(i), np.asarray(ring_knn(m, feats, k))


@pytest.mark.parametrize("world", [2, 4])
def test_ring_ops_match_jax_with_ties(tmp_path, world):
    q, x = _tied_cloud(world, 64, 96)
    feats = np.random.RandomState(5).randn(48, 8).astype(np.float32)
    k = 7
    jd, ji, jnb = _jax_ring(world, q, x, feats, k)
    outs = launch.spawn(_rank_ring, world, (q, x, feats, k), device="cpu",
                        deadline=DEADLINE, store_dir=str(tmp_path))
    d = np.concatenate([o[0] for o in outs])
    i = np.concatenate([o[1] for o in outs])
    nb = np.concatenate([o[2] for o in outs])
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(nb, jnb)
    # the ties are real: a lower global index with the same distance
    # exists for some query, and the ring kept the first-visited shard's
    full = ((q[:, None] - x[None]) ** 2).sum(-1)
    assert (full.argmin(1) != i).any()
    for layout in (o[3] for o in outs):
        shape, data_index, rows = layout
        assert shape == {"data": world // 2, "model": 2}
    # ranks sharing a data index hold the same slice (JAX replicates over
    # "model")
    rows = [o[3][2] for o in outs]
    assert rows[0] == rows[1] and rows[0] == [0, 1]
    if world == 4:
        assert rows[2] == rows[3] == [2, 3]


def _rank_one_shard_is_k3(mesh, q, x):
    d, i = tring.ring_min_sqdist(mesh, torch.from_numpy(q),
                                 torch.from_numpy(x))
    from parsenet_tpu_torch.ops.kernels import min_sqdist_with_idx
    d1, i1 = min_sqdist_with_idx(torch.from_numpy(q), torch.from_numpy(x))
    return (np.array_equal(d.numpy(), d1.numpy())
            and np.array_equal(i.numpy(), i1.numpy()))


def test_one_rank_ring_is_one_local_fold():
    """At W = 1 the ring is one call of the local fold (K3's plain version
    here), bit for bit."""
    q, x = _tied_cloud(0, 40, 80)
    mesh = tmesh.make_mesh(1, device="cpu")
    try:
        assert _rank_one_shard_is_k3(mesh, q, x)
        nb = tring.ring_knn(mesh, torch.from_numpy(x), 5)
        from parsenet_tpu_torch.ops.knn import knn
        ref = knn(torch.from_numpy(x)[None], 5)[0]
        # equal up to the order of exactly tied neighbours
        np.testing.assert_array_equal(np.sort(((x[:, None] - x[nb.numpy()])
                                               ** 2).sum(-1), 1),
                                      np.sort(((x[:, None] - x[ref.numpy()])
                                               ** 2).sum(-1), 1))
    finally:
        mesh.close()


def test_divisibility_errors_are_the_jax_packages():
    from parsenet_tpu.parallel.mesh import local_batch_size as j_local
    from parsenet_tpu.parallel.mesh import make_mesh as j_make
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        j_make(1, model_parallel=3)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        tmesh.make_mesh(1, model_parallel=3, device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_mesh(1, device="cpu")
    try:
        assert tmesh.local_batch_size(6, mesh) == 6
        assert mesh.shape == {"data": 1, "model": 1} and mesh.is_main
    finally:
        mesh.close()
    jm = j_make(4)
    with pytest.raises(ValueError, match="not divisible by 4 data shards"):
        j_local(6, jm)
    fake = tmesh.Mesh(4, 0, 1, torch.device("cpu"), False)
    with pytest.raises(ValueError, match="not divisible by 4 data shards"):
        tmesh.local_batch_size(6, fake)


def test_more_ranks_than_cards_raise_and_never_fall_back(monkeypatch):
    """No launcher and num_devices > 1: a single process cannot drive
    several cards, so make_mesh raises; on cards, more ranks than cards
    raise before any group is made; without a card "cuda" raises."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="only 1 CUDA devices"):
        tmesh.make_mesh(4)
    with pytest.raises(RuntimeError, match="only 1 CUDA devices"):
        launch.spawn(_rank_one_shard_is_k3, 2, (None, None), device="cuda")
    assert not torch.distributed.is_initialized()


def _rank_fails(mesh):
    raise ValueError(f"rank {mesh.rank} failed on purpose")


def _rank_hangs(mesh):
    import time
    time.sleep(600)


def test_spawn_reports_a_failed_rank_and_kills_a_hung_run(tmp_path):
    with pytest.raises(RuntimeError, match="failed on purpose"):
        launch.spawn(_rank_fails, 2, device="cpu", deadline=DEADLINE,
                     store_dir=str(tmp_path))
    with pytest.raises(TimeoutError):
        launch.spawn(_rank_hangs, 2, device="cpu", deadline=8.0,
                     store_dir=str(tmp_path))
