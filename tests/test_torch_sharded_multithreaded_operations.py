"""Concurrent ops against the port's sharded db spanning many shard files, on
the CPU, in every durability mode (a copy of
tests/test_sharded_multithreaded_operations.py, itself ported from reference
tests/test_sharded_multithreaded_operations.py with the same exact-count
assertions; sizes scaled for unit-test runtime)."""

import shutil
import threading
import time
import uuid

import numpy as np
import pytest

from minivectordb_tpu_torch import ShardedVectorDatabase


@pytest.mark.parametrize("durability", ["shard", "wal", "wal_fsync"])
def test_sharded_multithreaded_simultaneous_operations_torch(durability):
    folder = f"./tmp_shards_{uuid.uuid4().hex[:8]}"
    try:
        db = ShardedVectorDatabase(storage_dir=folder, shard_size=77,
                                   durability=durability, device="cpu")
        embedding_size = 128
        initial_size = 770

        unique_ids = [i for i in range(initial_size)]
        embeddings = [np.random.rand(embedding_size) for _ in range(initial_size)]
        metadata_dicts = [{"num_filter": f"test_{i}"} for i in range(initial_size)]
        db.store_embeddings_batch(unique_ids, embeddings, metadata_dicts)

        n_insert, n_search = 50, 50
        single_del = list(range(100, 250))
        batch_del = list(range(250, 400))

        def index_thread():
            for i in range(n_insert):
                db.store_embedding(
                    f"item_{uuid.uuid4()}",
                    np.random.rand(embedding_size),
                    metadata_dict={"num_filter": f"test_{i}"},
                )

        def search_thread():
            for _ in range(n_search):
                db.find_most_similar(np.random.rand(embedding_size), k=3)

        def delete_thread():
            for i in single_del:
                db.delete_embeddings_batch(i)

        def batch_delete_thread():
            for i in range(0, len(batch_del), 50):
                db.delete_embeddings_batch(batch_del[i : i + 50])

        threads = []
        for _ in range(3):
            threads.append(threading.Thread(target=index_thread))
            threads.append(threading.Thread(target=search_thread))
        threads.append(threading.Thread(target=delete_thread))
        threads.append(threading.Thread(target=batch_delete_thread))

        start = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.time() - start
        total_ops = 3 * (n_insert + n_search) + len(single_del) + 3
        print(f"Sharded multithreaded: {elapsed:.2f}s ({total_ops/elapsed:.0f} ops/sec)")

        expected = initial_size + 3 * n_insert - len(single_del) - len(batch_del)
        assert len(db.inverse_id_map) == expected
        assert len(db.unique_ids) == expected
        assert len(db.metadata) == expected
        assert len(db.embeddings) == expected

        # reload from disk must agree exactly (write-through persistence)
        db2 = ShardedVectorDatabase(storage_dir=folder, shard_size=77,
                                    durability=durability, device="cpu")
        assert len(db2.inverse_id_map) == expected
        assert len(db2.embeddings) == expected
        assert sorted(map(str, db2.unique_ids)) == sorted(map(str, db.unique_ids))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
