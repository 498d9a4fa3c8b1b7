"""The port's WAL fast-ingest mode: tests/test_wal.py's five cases against
minivectordb_tpu_torch on the CPU, plus the log's bytes against the JAX
package's, and a log left by either package replayed by the other."""

import os
import pickle
import shutil
import uuid

import numpy as np
import pytest

from minivectordb_tpu.core import wal as jwal
from minivectordb_tpu.sharded_vector_database import ShardedVectorDatabase as JaxSDB
from minivectordb_tpu_torch.core import wal as wal_mod
from minivectordb_tpu_torch.sharded_vector_database import ShardedVectorDatabase


def _tmp():
    return f"./tmp_wal_{uuid.uuid4().hex[:8]}"


def _db(folder, **kw):
    return ShardedVectorDatabase(storage_dir=folder, device="cpu", **kw)


def test_wal_record_roundtrip_and_torn_tail():
    folder = _tmp()
    os.makedirs(folder)
    try:
        path = os.path.join(folder, "wal.log")
        wal_mod.append_record(path, ("add", 1, np.ones(4, np.float32), {"a": 1}))
        wal_mod.append_record(path, ("del", [1]), fsync=True)
        with open(path, "ab") as f:
            f.write(b"\x4d\x56\x44\x57partial-garbage")
        ops = wal_mod.read_records(path)
        assert len(ops) == 2
        assert ops[0][0] == "add" and ops[0][1] == 1
        assert ops[1] == ("del", [1])
        # a corrupt CRC stops the replay at that record
        with open(path, "rb") as f:
            data = bytearray(f.read())
        data[wal_mod._HEADER.size + 3] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(data))
        assert wal_mod.read_records(path) == []
        wal_mod.truncate(path)
        assert not os.path.exists(path) and wal_mod.read_records(path) == []
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def test_wal_bytes_equal_the_jax_packages(tmp_path):
    ops = [("add", "u1", np.arange(6, dtype=np.float32), {"k": [1, 2]}),
           ("add", 7, np.zeros(6, np.float32), {}), ("del", ["u1", 7])]
    mine, theirs = str(tmp_path / "t.log"), str(tmp_path / "j.log")
    for op in ops:
        wal_mod.append_record(mine, op)
        jwal.append_record(theirs, op)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert [o[:2] for o in jwal.read_records(mine)] == [o[:2] for o in ops]
    assert [o[:2] for o in wal_mod.read_records(theirs)] == [o[:2] for o in ops]


def test_wal_mode_survives_reload_without_compact():
    folder = _tmp()
    try:
        db = _db(folder, shard_size=3, durability="wal")
        rng = np.random.default_rng(0)
        vecs = {i: rng.random(8).astype(np.float32) for i in range(10)}
        for i, v in vecs.items():
            db.store_embedding(i, v, {"i": i})
        db.delete_embeddings_batch([2, 5])
        db2 = _db(folder, shard_size=3, durability="wal")
        assert sorted(db2.inverse_id_map) == [0, 1, 3, 4, 6, 7, 8, 9]
        for i in db2.inverse_id_map:
            np.testing.assert_array_equal(db2.get_vector(i), vecs[i])
        assert not os.path.exists(os.path.join(folder, "wal.log"))
        db3 = _db(folder, shard_size=3)
        assert sorted(db3.inverse_id_map) == [0, 1, 3, 4, 6, 7, 8, 9]
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def test_wal_compact_produces_reference_schema_shards():
    folder = _tmp()
    try:
        db = _db(folder, shard_size=2, durability="wal")
        db.store_embeddings_batch(
            ["a", "b", "c"], list(np.eye(3, dtype=np.float32)),
            [{"k": "v"}, {}, {}],
        )
        db.compact()
        files = sorted(f for f in os.listdir(folder) if f.endswith(".pkl"))
        assert files == ["shard_0.pkl", "shard_1.pkl"]
        with open(os.path.join(folder, "shard_0.pkl"), "rb") as f:
            data = pickle.load(f)
        assert set(data.keys()) == {
            "embeddings", "metadata", "unique_ids", "inverted_index"
        }
        assert data["unique_ids"] == ["a", "b"]
        assert data["inverted_index"] == {"k": {"a"}}
        db2 = _db(folder, shard_size=2)
        assert sorted(db2.inverse_id_map) == ["a", "b", "c"]
    finally:
        shutil.rmtree(folder, ignore_errors=True)


@pytest.mark.parametrize("durability", ["wal", "wal_fsync"])
def test_wal_mode_search_identical_to_shard_mode(durability):
    f1, f2 = _tmp(), _tmp()
    try:
        rng = np.random.default_rng(1)
        mat = rng.standard_normal((50, 16)).astype(np.float32)
        dbs = [_db(f1, shard_size=7), _db(f2, shard_size=7, durability=durability)]
        for db in dbs:
            db.store_embeddings_batch(
                list(range(50)), list(mat), [{"p": i % 3} for i in range(50)]
            )
            db.delete_embeddings_batch([3, 14])
        q = rng.standard_normal(16).astype(np.float32)
        res = [db.find_most_similar(q, metadata_filter={"p": 1}, k=5) for db in dbs]
        assert list(res[0][0]) == list(res[1][0])
        np.testing.assert_allclose(
            np.asarray(res[0][1], np.float64), np.asarray(res[1][1], np.float64),
            rtol=1e-6,
        )
    finally:
        shutil.rmtree(f1, ignore_errors=True)
        shutil.rmtree(f2, ignore_errors=True)


def test_invalid_durability_mode():
    with pytest.raises(ValueError):
        _db(_tmp(), durability="bogus")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_wal_left_by_one_package_replays_in_the_other(tmp_path, writer):
    """A 'wal' session that never compacts; the other package opens the
    directory, replays the log, compacts it into shard files and gives the
    same rows, bit for bit."""
    folder = str(tmp_path / "w")
    rng = np.random.default_rng(2)
    mat = rng.standard_normal((40, 12)).astype(np.float32)
    if writer == "jax":
        w = JaxSDB(storage_dir=folder, shard_size=8, durability="wal")
    else:
        w = _db(folder, shard_size=8, durability="wal")
    w.store_embeddings_batch([f"r{i}" for i in range(30)], mat[:30],
                             [{"i": i} for i in range(30)])
    for i in range(30, 40):
        w.store_embedding(f"r{i}", mat[i], {"i": i})
    w.delete_embeddings_batch(["r4", "r33"])
    assert os.path.exists(os.path.join(folder, "wal.log"))
    del w
    if writer == "jax":
        r = _db(folder, shard_size=8, durability="wal")
    else:
        r = JaxSDB(storage_dir=folder, shard_size=8, durability="wal")
    assert not os.path.exists(os.path.join(folder, "wal.log"))
    live = [f"r{i}" for i in range(40) if i not in (4, 33)]
    assert list(r.unique_ids) == live
    assert list(r.metadata) == [{"i": int(u[1:])} for u in live]
    for u in live:
        assert np.asarray(r.get_vector(u)).tobytes() == mat[int(u[1:])].tobytes()
