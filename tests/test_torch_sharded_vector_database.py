"""ShardedSuite (tests/_sharded_suite.py, the reference's 28 sharded test
bodies and the semantic ones) against the port's ShardedVectorDatabase on
the CPU, through a ``make`` that passes ``device="cpu"``; plus the port's own
checks of its constructor and of the files it writes."""

import os
import re

import numpy as np
import pytest
import torch

from minivectordb_tpu_torch import ShardedVectorDatabase, VectorDatabase

from _sharded_suite import ShardedSuite, temp_dir_db


class PortSuite(ShardedSuite):
    """The shared suite with the port's class on the CPU. The two bodies that
    reach for the JAX package's flat database or encoder use the port's."""

    def make(self, folder, **kwargs):
        return self.db_cls(storage_dir=folder, device="cpu", **kwargs)

    def test_migrate_from_non_sharded_version(self, tmp_path):
        with temp_dir_db(self.db_cls) as folder:
            sdb = self.make(folder)
            vdb = VectorDatabase(str(tmp_path / "flat.pkl"), device="cpu")
            vdb.store_embedding(1, [0.5, 0.5])
            vdb.store_embedding(2, [0.1, 0.1])
            vdb.store_embedding(3, [0.2, 0.2], {"k": 3})
            sdb._convert_from_non_sharded_db(vdb)
            assert len(sdb.inverse_id_map) == 3
            assert sdb.metadata == [{}, {}, {"k": 3}]
            assert (sdb.get_vector(3) == np.float32([0.2, 0.2])).all()

    def _semantic_model(self, kind="builtin"):
        from minivectordb_tpu_torch import EmbeddingModel

        if kind == "builtin":
            m = EmbeddingModel(device="cpu")
        else:
            m = EmbeddingModel(use_quantized_onnx_model=False,
                               alternative_model=kind, device="cpu")
        if not m.is_trained:
            pytest.skip(f"trained weights for '{kind}' unavailable offline")
        return m


class TestTorchShardedVectorDatabase(PortSuite):
    db_cls = ShardedVectorDatabase
    lower_is_better = False


def test_shard_dir_stays_loadable_by_the_reference_loader(tmp_path):
    """Every file the richest configuration writes is a well-formed
    shard_<N>.pkl or not a .pkl at all (the reference's loader int()-parses
    every .pkl name, reference sharded_vector_database.py:45-46)."""
    folder = str(tmp_path / "richest")
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((300, 16)).astype(np.float32)
    db = ShardedVectorDatabase(
        storage_dir=folder, shard_size=50, durability="wal", index="ivf",
        ivf_opts={"build_threshold": 64, "nlist": 4, "nprobe": 64, "iters": 3},
        device="cpu",
    )
    db.store_embeddings_batch(list(range(300)), mat)
    db.find_most_similar(mat[1], k=3)  # IVF build -> sidecar write
    assert os.path.exists(os.path.join(folder, "ivf_layout.bin"))
    db.delete_embeddings_batch([5])
    db.compact()
    names = os.listdir(folder)
    assert "wal.log" not in names
    for name in names:
        if name.endswith(".pkl"):
            assert re.fullmatch(r"shard_(\d+)\.pkl", name), name


def test_device_defaults_to_cuda_and_mesh_raises(tmp_path):
    folder = str(tmp_path / "d")
    if torch.cuda.is_available():
        assert ShardedVectorDatabase(folder).stats()["count"] == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedVectorDatabase(folder)
    # mesh= is ported (parallel/): what is not a Mesh raises
    with pytest.raises(TypeError, match="Mesh"):
        ShardedVectorDatabase(folder, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        ShardedVectorDatabase(folder, durability="bogus", device="cpu")
    db = ShardedVectorDatabase(folder, device="cpu")
    assert db._engine.ivf_sidecar == os.path.join(folder, "ivf_layout.bin")
    assert db._engine.device == torch.device("cpu")


def test_stats_shards_batch_async_and_rerank(tmp_path):
    rng = np.random.default_rng(5)
    n, d = 4500, 24
    mat = rng.standard_normal((n, d)).astype(np.float32)
    db = ShardedVectorDatabase(str(tmp_path / "s"), shard_size=1000, device="cpu")
    db.store_embeddings_batch(list(range(n)), mat, [{"b": i % 4} for i in range(n)])
    st = db.stats()
    assert st["shards"] == 5 and st["count"] == n and len(db.box_item_map) == 5
    assert db.inverse_box_item_map[4499] == 4
    q = rng.standard_normal((32, d)).astype(np.float32)
    res = db.find_most_similar_batch(q, k=5)
    handle = db.find_most_similar_batch_async(q, k=5)
    assert [r[0] for r in handle.result()] == [r[0] for r in res]
    per = db.find_most_similar_batch(q, k=5, metadata_filters=[{"b": i % 4} for i in range(32)])
    assert all(md["b"] == i % 4 for i, (_i, _s, mds) in enumerate(per) for md in mds)
    with pytest.raises(ValueError):
        db.find_most_similar_batch(q, k=5, metadata_filter={"b": 1}, metadata_filters=[None] * 32)
    # the rerank runs on the database's device (here the CPU), at 32+ by default
    texts = [f"text number {i} about vectors" for i in range(40)]
    scores = rng.random(40).tolist()
    assert db.hybrid_rerank_results(texts, scores, "number 7", k=3) == \
        db.hybrid_rerank_results(texts, scores, "number 7", k=3, device=True)
    host = db.hybrid_rerank_results(texts, scores, "number 7", k=3, device=False)
    assert list(db.hybrid_rerank_results(texts, scores, "number 7", k=3)[0]) == list(host[0])
