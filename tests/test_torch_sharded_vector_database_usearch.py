"""ShardedSuite against the port's ShardedVectorDatabaseUsearch on the CPU
(int8 corpus, cosine distances), plus the JAX tests' int8 checks."""

import numpy as np
import pytest
import torch

from minivectordb_tpu_torch import ShardedVectorDatabaseUsearch

from _sharded_suite import temp_dir_db
from test_torch_sharded_vector_database import PortSuite


class TestTorchShardedVectorDatabaseUsearch(PortSuite):
    db_cls = ShardedVectorDatabaseUsearch
    lower_is_better = True

    def test_distances_are_lower_is_better(self):
        with temp_dir_db(self.db_cls) as folder:
            db = self.make(folder)
            db.store_embedding(1, [1.0, 0.0])
            db.store_embedding(2, [0.0, 1.0])
            ids, distances, _ = db.find_most_similar([1.0, 0.1], k=2)
            assert ids[0] == 1
            assert distances[0] < 0.1
            assert distances[1] > 0.5


@pytest.mark.parametrize("batch", [1, 32])
def test_int8_recall_vs_f32_oracle_random_corpus(tmp_path, batch):
    """recall@10 against the float32 oracle stays high and distances ascend,
    within int8 quantization of the true cosine distance; batch 32 over a
    4,096-row capacity takes the fused route (K2's plain version here)."""
    rng = np.random.default_rng(11)
    n, d, k = 5000, 64, 10
    mat = rng.standard_normal((n, d)).astype(np.float32)
    db = ShardedVectorDatabaseUsearch(
        storage_dir=str(tmp_path / "u8"), shard_size=1024, device="cpu")
    db.store_embeddings_batch([f"u{i}" for i in range(n)], list(mat))
    qs = rng.standard_normal((32, d)).astype(np.float32)
    if batch == 1:
        results = [db.find_most_similar(q, k=k) for q in qs]
    else:
        results = db.find_most_similar_batch(qs, k=k)
    norms = np.maximum(np.linalg.norm(mat, axis=1), 1e-30)
    hits = 0
    for q, (ids, dists, _) in zip(qs, results):
        assert all(dists[i] <= dists[i + 1] + 1e-6 for i in range(len(dists) - 1))
        sims = (mat @ (q / np.linalg.norm(q))) / norms
        order = np.argsort(-sims)[:k]
        hits += len(set(ids) & {f"u{r}" for r in order})
        assert abs(dists[0] - (1.0 - sims[order[0]])) < 0.05
    assert hits / (32 * k) >= 0.9


def test_device_passes_through(tmp_path):
    folder = str(tmp_path / "u")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedVectorDatabaseUsearch(folder)
    db = ShardedVectorDatabaseUsearch(folder, durability="wal", device="cpu")
    assert db.stats()["device_dtype"] == "int8" and db._use_wal
    db.store_embeddings_batch([1, 2, 3], np.eye(3, dtype=np.float32))
    ids, dists, _ = db.find_most_similar([1.0, 0.05, 0.0], k=3, autocut=True)
    assert ids[0] == 1 and len(ids) == 1
