"""Mongo-like operator suite against the port's ShardedVectorDatabase on the
CPU (a copy of tests/test_sharded_mongolike_operators.py, itself ported from
reference tests/test_sharded_mongolike_operators.py — mirrors the flat
operator suite in a temp shard dir), in every durability mode."""

import shutil
import uuid
from contextlib import contextmanager
from datetime import datetime

import numpy as np
import pytest

from minivectordb_tpu_torch import ShardedVectorDatabase

DURABILITY = ["shard", "wal", "wal_fsync"]


@contextmanager
def _tmpdb(**kwargs):
    folder = f"./tmp_shards_{uuid.uuid4().hex[:8]}"
    try:
        yield ShardedVectorDatabase(storage_dir=folder, device="cpu", **kwargs)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


@pytest.mark.parametrize("durability", DURABILITY)
def test_multifilters_options_sharded_torch(durability):
    with _tmpdb(durability=durability) as db:
        embedding_size = 4
        for i in range(50):
            db.store_embedding(
                f"item_{i}",
                np.random.rand(embedding_size),
                metadata_dict={"num_filter": f"test_{np.random.randint(1, 5)}"},
            )
        for i in range(10):
            db.store_embedding(
                f"item_{i + 50}",
                np.random.rand(embedding_size),
                metadata_dict={
                    "num_filter": "test_10",
                    "value": 10,
                    "date": datetime(2021, 1, 1),
                },
            )
        for i in range(10):
            db.store_embedding(
                f"item_{i + 60}",
                np.random.rand(embedding_size),
                metadata_dict={
                    "num_filter": "test_20",
                    "value": 20,
                    "date": datetime(2022, 1, 1),
                },
            )

        results = db.find_most_similar(
            np.random.rand(embedding_size), k=999, metadata_filter={"value": 10}
        )
        assert len(results[2]) == 10
        for r in results[2]:
            assert r["value"] == 10

        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=999,
            metadata_filter={"value": {"$gte": 10}},
        )
        assert len(results[2]) == 20

        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=999,
            metadata_filter={"value": {"$ne": 10}},
        )
        assert len(results[2]) == 10

        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=999,
            metadata_filter={"date": {"$lt": datetime(2022, 1, 1)}},
        )
        assert len(results[2]) == 10

        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=999,
            or_filters=[
                {"value": {"$gte": 10}},
                {"date": {"$lte": datetime(2022, 1, 1)}},
            ],
        )
        assert len(results[2]) == 20

        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=999,
            metadata_filter={
                "date": {"$gte": datetime(2021, 1, 1), "$lte": datetime(2022, 1, 1)}
            },
        )
        assert len(results[2]) == 20

        with pytest.raises(Exception):
            db.find_most_similar(
                np.random.rand(embedding_size),
                k=999,
                metadata_filter={"value": {"$invalid": 10}},
            )
        with pytest.raises(Exception):
            db.find_most_similar(
                np.random.rand(embedding_size),
                k=999,
                or_filters=[{"value": {"$invalid": 10}}],
            )


@pytest.mark.parametrize("durability", DURABILITY)
def test_in_operator_sharded_torch(durability):
    with _tmpdb(durability=durability) as db:
        embedding_size = 4
        first_id = str(uuid.uuid4())
        db.store_embedding(
            first_id,
            np.random.rand(embedding_size),
            metadata_dict={"custom_list": ["a", "b", "c"]},
        )
        second_id = str(uuid.uuid4())
        db.store_embedding(
            second_id,
            np.random.rand(embedding_size),
            metadata_dict={"custom_list": ["d", "e", "f"]},
        )

        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=2,
            metadata_filter={"custom_list": {"$in": "a"}},
        )
        assert first_id in results[0]
        assert len(results[0]) == 1

        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=2,
            or_filters=[{"custom_list": {"$in": "a"}}, {"custom_list": {"$in": "d"}}],
        )
        assert first_id in results[0]
        assert second_id in results[0]
        assert len(results[0]) == 2


@pytest.mark.parametrize("durability", DURABILITY)
def test_filtering_no_results_sharded_torch(durability):
    with _tmpdb(durability=durability) as db:
        embedding_size = 4
        for i in range(50):
            db.store_embedding(
                f"item_{i}",
                np.random.rand(embedding_size),
                metadata_dict={"num_filter": f"test_{np.random.randint(1, 5)}", "value": 1},
            )
        results = db.find_most_similar(
            np.random.rand(embedding_size),
            k=999,
            or_filters={"value": 1},
            metadata_filter={"value": 2},
        )
        assert len(results[2]) == 0
