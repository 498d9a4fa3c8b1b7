"""Mesh-backed databases of the port (``mesh=`` on the public classes)
against the JAX package's with a mesh on its 8 virtual CPU devices, and
against the port's own single-device path.

The port's mesh is search_mesh(8, device="cpu"): 8 logical shards of the
host. Tolerances: ids equal where scores are not tied; scores within 1e-5
(float32 and 'mixed': exact float32 rescoring), 2e-2 (bfloat16) and 1e-5
(int8: integer dots, the same float32 scales)."""

import numpy as np
import pytest
import torch

from minivectordb_tpu.parallel.mesh import search_mesh as jax_search_mesh
from minivectordb_tpu.sharded_vector_database import ShardedVectorDatabase as JaxSharded
from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import ShardedVectorDatabase as TorchSharded
from minivectordb_tpu_torch import ShardedVectorDatabaseUsearch as TorchUsearch
from minivectordb_tpu_torch import VectorDatabase as TorchDB
from minivectordb_tpu_torch.parallel.dist_scan import DistributedScanIndex
from minivectordb_tpu_torch.parallel.mesh import search_mesh

ATOL = {"float32": 1e-5, "mixed": 1e-5, "bfloat16": 2e-2, "int8": 1e-5}


def _mesh():
    return search_mesh(8, device="cpu")


def _same_hits(got, want, atol):
    assert len(got) == len(want)
    for (g_ids, g_s, _), (w_ids, w_s, _) in zip(got, want):
        assert len(g_ids) == len(w_ids)
        np.testing.assert_allclose(np.asarray(g_s, np.float64),
                                   np.asarray(w_s, np.float64), rtol=0, atol=atol)
        for j, (a, b) in enumerate(zip(g_ids, w_ids)):
            if a != b:  # only where neighbouring scores are tied
                near = [abs(w_s[j] - w_s[i]) for i in (j - 1, j + 1)
                        if 0 <= i < len(w_s)]
                assert min(near) <= 2 * atol, (g_ids, w_ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "mixed"])
def test_flat_db_with_mesh_matches_jax_mesh_and_single_device(dtype, tmp_path):
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((3000, 32)).astype(np.float32)
    metas = [{"g": int(i % 5)} for i in range(3000)]
    db1 = TorchDB(storage_file=str(tmp_path / "a.pkl"), device_dtype=dtype, device="cpu")
    dbm = TorchDB(storage_file=str(tmp_path / "b.pkl"), device_dtype=dtype, mesh=_mesh())
    dbj = JaxDB(storage_file=str(tmp_path / "c.pkl"), device_dtype=dtype,
                mesh=jax_search_mesh(8))
    assert dbm._engine.device == torch.device("cpu")
    for db in (db1, dbm, dbj):
        db.store_embeddings_batch(list(range(3000)), list(mat), list(metas))
    q = rng.standard_normal((20, 32)).astype(np.float32)
    atol = ATOL[dtype]
    for kw in ({}, {"metadata_filter": {"g": 2}}):
        got = dbm.find_most_similar_batch(q, k=7, **kw)
        _same_hits(got, dbj.find_most_similar_batch(q, k=7, **kw), atol)
        _same_hits(got, db1.find_most_similar_batch(q, k=7, **kw), atol)
    got = dbm.find_most_similar(q[0], k=9, metadata_filter={"g": 2})
    assert all(m["g"] == 2 for m in got[2])
    # mutation re-syncs the distributed buffer (eager compaction on a mesh)
    for db in (db1, dbm, dbj):
        db.delete_embedding(int(got[0][0]))
    r1 = db1.find_most_similar(q[0], metadata_filter={"g": 2}, k=9)
    rm = dbm.find_most_similar(q[0], metadata_filter={"g": 2}, k=9)
    rj = dbj.find_most_similar(q[0], metadata_filter={"g": 2}, k=9)
    _same_hits([rm], [rj], atol)
    _same_hits([rm], [r1], atol)
    assert dbm._engine.store.dead_count == 0  # compacted, not tombstoned
    assert isinstance(dbm._engine._dist, DistributedScanIndex)


def test_sharded_db_with_mesh(tmp_path):
    folder = str(tmp_path / "shards")
    db = TorchSharded(storage_dir=folder, shard_size=100, mesh=_mesh(), durability="wal")
    rng = np.random.default_rng(1)
    mat = rng.standard_normal((500, 16)).astype(np.float32)
    db.store_embeddings_batch(list(range(500)), list(mat))
    ids, scores, _ = db.find_most_similar(mat[123], k=3)
    assert ids[0] == 123
    assert scores[0] > 0.9999
    jdb = JaxSharded(storage_dir=str(tmp_path / "jshards"), shard_size=100,
                     mesh=jax_search_mesh(8), durability="wal")
    jdb.store_embeddings_batch(list(range(500)), list(mat))
    q = rng.standard_normal((6, 16)).astype(np.float32)
    _same_hits(db.find_most_similar_batch(q, k=5), jdb.find_most_similar_batch(q, k=5), 1e-5)
    # deletes, a reopen (WAL replay) and the mesh again
    db.delete_embeddings_batch([123, 7])
    del db
    db = TorchSharded(storage_dir=folder, shard_size=100, mesh=_mesh(), durability="wal")
    ids, _, _ = db.find_most_similar(mat[123], k=3)
    assert 123 not in ids and db.stats()["count"] == 498


def test_sharded_usearch_with_mesh(tmp_path):
    """The int8 class on a mesh: cosine distances ascending, the single-
    device int8 class's rows."""
    rng = np.random.default_rng(6)
    mat = rng.standard_normal((900, 24)).astype(np.float32)
    dbm = TorchUsearch(storage_dir=str(tmp_path / "m"), shard_size=200, mesh=_mesh())
    db1 = TorchUsearch(storage_dir=str(tmp_path / "s"), shard_size=200, device="cpu")
    for db in (dbm, db1):
        db.store_embeddings_batch(list(range(900)), list(mat))
    assert dbm._engine.device_dtype == "int8"
    for b in range(3):
        got = dbm.find_most_similar(mat[b * 100], k=5)
        want = db1.find_most_similar(mat[b * 100], k=5)
        assert got[0][0] == b * 100 and list(got[1]) == sorted(got[1])
        _same_hits([got], [want], 1e-5)


def test_mesh_async_batch_matches_sync(tmp_path):
    """search_batch_async on a mesh database stays pipelined (tensors until
    .result()) and agrees with the synchronous path."""
    db = TorchDB(storage_file=str(tmp_path / "m.pkl"), mesh=_mesh())
    rng = np.random.default_rng(3)
    mat = rng.standard_normal((1024, 32)).astype(np.float32)
    db.store_embeddings_batch(list(range(1024)), list(mat))
    q = mat[:6] + 0.01
    sync_res = db.find_most_similar_batch(q, k=5)
    async_res = db.find_most_similar_batch_async(q, k=5).result()
    for s, a in zip(sync_res, async_res):
        assert list(s[0]) == list(a[0])
        np.testing.assert_allclose(
            np.asarray(s[1], np.float32), np.asarray(a[1], np.float32),
            rtol=1e-5, atol=1e-6,
        )
    # a filtered async dispatch on the mesh too
    got = db.find_most_similar_batch_async(q, k=5, metadata_filter=None).result()
    assert [g[0] for g in got] == [s[0] for s in sync_res]


def test_mesh_engine_takes_a_tensor_batch(tmp_path):
    """A tensor query batch on a mesh database gives the numpy batch's
    results (tests/test_device_query.py:181: the JAX mesh engine converts a
    device batch; the port moves the tensor to each shard's device)."""
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((512, 32)).astype(np.float32)
    db = TorchDB(storage_file=str(tmp_path / "t.pkl"), mesh=_mesh())
    db.store_embeddings_batch(list(range(512)), mat, [{"g": i % 3} for i in range(512)])
    q = rng.standard_normal((4, 32)).astype(np.float32)
    for kw in ({}, {"metadata_filter": {"g": 0}}):
        res_np = db.find_most_similar_batch(q, k=5, **kw)
        res_t = db.find_most_similar_batch(torch.from_numpy(q), k=5, **kw)
        _same_hits(res_t, res_np, 0.0)
        pend = db.find_most_similar_batch_async(torch.from_numpy(q), k=5, **kw)
        _same_hits(pend.result(), res_np, 0.0)


def test_mesh_argument_is_checked(tmp_path):
    path = str(tmp_path / "x.pkl")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TorchDB(storage_file=path, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        TorchDB(storage_file=path, mesh=_mesh(), device="meta")
    db = TorchDB(storage_file=path, mesh=_mesh(), device="cpu")
    assert db._engine.mesh.devices.size == 8


def test_mesh_engine_load_twice_serves_the_second_corpus(tmp_path):
    """A second load() on a synced mesh engine, with fewer rows than the
    first, re-ships the mesh's row blocks: searches see the new rows only."""
    rng = np.random.default_rng(9)
    first = rng.standard_normal((1024, 32)).astype(np.float32)
    second = rng.standard_normal((512, 32)).astype(np.float32)
    db = TorchDB(storage_file=str(tmp_path / "l.pkl"), mesh=_mesh())
    eng = db._engine
    with eng.lock:
        eng.load(first, list(range(1024)), [{} for _ in range(1024)])
    assert list(db.find_most_similar(first[700], k=1)[0]) == [700]
    with eng.lock:
        eng.load(second, list(range(5000, 5512)), [{} for _ in range(512)])
    for row in (3, 300, 511):
        ids, scores, _ = db.find_most_similar(second[row], k=3)
        assert ids[0] == 5000 + row and scores[0] > 0.9999
        assert all(uid >= 5000 for uid in ids)
    assert eng._dist.count == 512
