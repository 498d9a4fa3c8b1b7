"""Shard directories across the packages, both ways: a directory written by
the JAX package's sharded class opens in the port's (on the CPU), and the
reverse, for ShardedVectorDatabase and ShardedVectorDatabaseUsearch, in
"shard" and "wal" mode. Uids, metadata and get_vector rows must be equal bit
for bit; search hits equal ids with scores within 1e-5 (float32 sums in
another order; int8 dots are exact). An index="ivf" directory (shard files
plus ivf_layout.bin) written by either opens in the other without a new
k-means, and at nprobe = nlist its hits equal the flat scan's."""

import os

import numpy as np
import pytest

from minivectordb_tpu.sharded_vector_database import ShardedVectorDatabase as JaxSDB
from minivectordb_tpu.sharded_vector_database_usearch import (
    ShardedVectorDatabaseUsearch as JaxUSDB,
)
from minivectordb_tpu_torch import ShardedVectorDatabase, ShardedVectorDatabaseUsearch

N, D, SHARD = 700, 16, 128
CLASSES = {
    "flat": (JaxSDB, ShardedVectorDatabase),
    "usearch": (JaxUSDB, ShardedVectorDatabaseUsearch),
}


def _open(package, kind, folder, **kw):
    jax_cls, torch_cls = CLASSES[kind]
    if package == "jax":
        return jax_cls(storage_dir=folder, shard_size=SHARD, **kw)
    return torch_cls(storage_dir=folder, shard_size=SHARD, device="cpu", **kw)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((N, D)).astype(np.float32)
    uids = [f"id{i}" if i % 3 else i for i in range(N)]
    metas = [{"b": i % 5, "tag": f"t{i % 7}"} for i in range(N)]
    queries = rng.standard_normal((20, D)).astype(np.float32)
    return mat, uids, metas, queries


def _write(db, mat, uids, metas):
    db.store_embeddings_batch(uids[:500], mat[:500], metas[:500])
    for i in range(500, N):
        db.store_embedding(uids[i], mat[i], metas[i])
    db.delete_embeddings_batch([uids[3], uids[250], uids[600]])


def _same_hits(got, want):
    assert list(got[0]) == list(want[0])
    assert list(got[2]) == list(want[2])
    np.testing.assert_allclose(np.asarray(got[1], np.float64),
                               np.asarray(want[1], np.float64), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["flat", "usearch"])
@pytest.mark.parametrize("durability", ["shard", "wal"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_directory_crosses_packages(tmp_path, kind, durability, writer):
    reader = "torch" if writer == "jax" else "jax"
    folder = str(tmp_path / "dir")
    mat, uids, metas, queries = _data()
    w = _open(writer, kind, folder, durability=durability)
    _write(w, mat, uids, metas)
    want = [w.find_most_similar(q, k=7) for q in queries]
    want_f = [w.find_most_similar(q, k=7, metadata_filter={"b": 2}) for q in queries[:5]]
    w_uids, w_meta = list(w.unique_ids), list(w.metadata)
    w_box = {s: list(u) for s, u in w.box_item_map.items()}
    del w
    r = _open(reader, kind, folder, durability=durability)
    assert not os.path.exists(os.path.join(folder, "wal.log"))
    assert list(r.unique_ids) == w_uids and list(r.metadata) == w_meta
    assert {s: list(u) for s, u in r.box_item_map.items()} == w_box
    assert r.stats()["shards"] == len(w_box)
    rows = {u: i for i, u in enumerate(uids)}
    for u in w_uids:
        assert np.asarray(r.get_vector(u)).tobytes() == mat[rows[u]].tobytes()
    for q, h in zip(queries, want):
        _same_hits(r.find_most_similar(q, k=7), h)
    for q, h in zip(queries[:5], want_f):
        _same_hits(r.find_most_similar(q, k=7, metadata_filter={"b": 2}), h)
    # the reader writes on; the writer's package reads it back
    r.store_embedding("late", mat[0] * 2.0, {"b": 9})
    r.delete_embeddings_batch([w_uids[10]])
    if durability == "wal":
        r.compact()
    r_box = {s: list(u) for s, u in r.box_item_map.items()}
    del r
    back = _open(writer, kind, folder, durability=durability)
    # rows come back in shard order: "late" fills the first shard with room
    assert {s: list(u) for s, u in back.box_item_map.items()} == r_box
    assert list(back.unique_ids) == [u for s in sorted(r_box) for u in r_box[s]]
    assert sorted(map(str, back.unique_ids)) == sorted(
        map(str, [u for u in w_uids if u != w_uids[10]] + ["late"]))
    assert np.asarray(back.get_vector("late")).tobytes() == (mat[0] * 2.0).tobytes()


IVF_OPTS = {"build_threshold": 256, "nlist": 8, "nprobe": 2, "iters": 4,
            "lists_dtype": "float32"}


def _ivf(package, folder):
    if package == "jax":
        return JaxSDB(storage_dir=folder, shard_size=SHARD, index="ivf",
                      ivf_opts=IVF_OPTS)
    return ShardedVectorDatabase(storage_dir=folder, shard_size=SHARD, index="ivf",
                                 ivf_opts=IVF_OPTS, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ivf_directory_crosses_packages(tmp_path, writer):
    reader = "torch" if writer == "jax" else "jax"
    folder = str(tmp_path / "ivf")
    mat, uids, metas, queries = _data(3)
    w = _ivf(writer, folder)
    w.store_embeddings_batch(uids, mat, metas)
    w.find_most_similar(queries[0], k=5)  # builds; writes ivf_layout.bin
    assert w.stats()["ivf"]["built"]
    assert os.path.exists(os.path.join(folder, "ivf_layout.bin"))
    nlist = w.stats()["ivf"]["nlist_effective"]
    del w
    r = _ivf(reader, folder)
    assert r.stats()["ivf"]["pending_attach"]
    flat = (ShardedVectorDatabase(str(tmp_path / "flat"), device="cpu"))
    flat.store_embeddings_batch(uids, mat, metas)
    for q in queries:
        _same_hits(r.find_most_similar(q, k=5, nprobe=nlist), flat.find_most_similar(q, k=5))
    ops = r.stats()["ops"]
    assert "ivf_build" not in ops and ops["ivf_attach"]["count"] == 1
    assert r.stats()["ivf"]["nlist_effective"] == nlist
