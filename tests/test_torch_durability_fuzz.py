"""Durability fuzz on the port's sharded database, on the CPU: any random
op interleaving, persisted and reloaded, must reproduce the exact live
corpus, in every durability mode (the sharded cases of
tests/test_durability_fuzz.py, with its op generator and oracle). A last
case hands the fuzzed directory to the JAX package, which must read the
same corpus."""

import random

import numpy as np
import pytest

from minivectordb_tpu.sharded_vector_database import ShardedVectorDatabase as JaxSDB
from minivectordb_tpu_torch import ShardedVectorDatabase

from test_durability_fuzz import _check_matches_oracle, _run_ops


def _open(sdir, durability):
    return ShardedVectorDatabase(storage_dir=sdir, shard_size=16,
                                 durability=durability, device="cpu")


@pytest.mark.parametrize("durability", ["shard", "wal", "wal_fsync"])
def test_sharded_random_ops_survive_reload(tmp_path, durability):
    rng = random.Random(7)
    nprng = np.random.default_rng(7)
    sdir = str(tmp_path / durability)
    db = _open(sdir, durability)
    live = {}
    _run_ops(db, rng, nprng, live)
    _check_matches_oracle(db, live, nprng)
    del db

    re = _open(sdir, durability)
    assert sorted(re.unique_ids) == sorted(live)
    for u in rng.sample(sorted(live), 10):
        np.testing.assert_allclose(
            np.asarray(re.get_vector(u), np.float32), live[u],
            rtol=1e-6, atol=1e-7,
        )
    _check_matches_oracle(re, live, nprng)
    _run_ops(re, rng, nprng, live, n_steps=40)
    del re
    re2 = _open(sdir, durability)
    assert sorted(re2.unique_ids) == sorted(live)
    _check_matches_oracle(re2, live, nprng)


@pytest.mark.parametrize("durability", ["shard", "wal"])
def test_fuzzed_directory_reads_the_same_in_the_jax_package(tmp_path, durability):
    rng = random.Random(11)
    nprng = np.random.default_rng(11)
    sdir = str(tmp_path / durability)
    db = _open(sdir, durability)
    live = {}
    _run_ops(db, rng, nprng, live, n_steps=80)
    want_uids = list(db.unique_ids)
    del db
    jdb = JaxSDB(storage_dir=sdir, shard_size=16, durability=durability)
    assert sorted(jdb.unique_ids) == sorted(live) == sorted(want_uids)
    for u in sorted(live):
        assert np.asarray(jdb.get_vector(u)).tobytes() == live[u].tobytes()
    _check_matches_oracle(jdb, live, nprng)
