"""Lockstep differential sweep of the sharded classes: the port's
ShardedVectorDatabase (device="cpu") in every durability mode, and its
ShardedVectorDatabaseUsearch, against the JAX package's on one seeded op
sequence each. First tests/test_durability_fuzz.py's own op generator and
oracle (``_run_ops``, ``_check_matches_oracle``) drive the pair, then
tests/_differential.py's sequence (stores, batch stores,
delete_embeddings_batch, get_vector, single / batch / per-query-filter /
async searches with test_filter_fuzz's filters, error probes), with reopens
of each package on its own directory and on the other package's (shard
pickles and, for "wal" and "wal_fsync", wal.log replayed at the reopen).

Tolerance: scores (the usearch class's distances too) within
2e-5 (float32 sums in another order); ids equal where the scores are not
tied within it; metadata equal; outside the usearch class (distances) the
port is held to the exact numpy oracle at every search of the sequence, and
the oracle decides a divergence. Seeds: SEEDS per class and mode, sized so
the file runs in about a minute serially on a CPU.
"""

import gc
import random

import numpy as np
import pytest

from minivectordb_tpu.sharded_vector_database import ShardedVectorDatabase as JaxSDB
from minivectordb_tpu.sharded_vector_database_usearch import (
    ShardedVectorDatabaseUsearch as JaxUsearch,
)
from minivectordb_tpu_torch import ShardedVectorDatabase, ShardedVectorDatabaseUsearch

from _differential import Lockstep, run_sequence
from test_durability_fuzz import _check_matches_oracle, _run_ops

SEEDS = list(range(8))
N_OPS = 70
SHARD_SIZE = 48
CLASSES = {"shard": (JaxSDB, ShardedVectorDatabase, "shard"),
           "wal": (JaxSDB, ShardedVectorDatabase, "wal"),
           "wal_fsync": (JaxSDB, ShardedVectorDatabase, "wal_fsync"),
           "usearch": (JaxUsearch, ShardedVectorDatabaseUsearch, "shard")}


def _sharded_lockstep(tmp_path, which) -> Lockstep:
    jax_cls, port_cls, durability = CLASSES[which]
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]

    def reopen(swap):
        if swap:
            dirs.reverse()
        return (jax_cls(storage_dir=dirs[0], shard_size=SHARD_SIZE, durability=durability),
                port_cls(storage_dir=dirs[1], shard_size=SHARD_SIZE, durability=durability,
                         device="cpu"))

    lower = (("find_most_similar", "find_most_similar_batch", "find_most_similar_batch_async")
             if which == "usearch" else ())  # the int8 class answers distances
    return Lockstep(*reopen(False), tol=2e-5, reopen=reopen, lower_is_better=lower,
                    oracle=which != "usearch")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", list(CLASSES))
def test_sharded_lockstep(tmp_path, which, seed):
    db = _sharded_lockstep(tmp_path, which)
    # the JAX durability fuzz's generator and oracle, through both packages
    rng, nprng = random.Random(seed), np.random.default_rng(seed)
    live = {}
    _run_ops(db, rng, nprng, live, n_steps=60)
    if which != "usearch":  # the oracle reads similarities; usearch answers distances
        _check_matches_oracle(db, live, nprng)
    db.reopen(swap=True)
    assert sorted(db.unique_ids) == sorted(live)
    for u in rng.sample(sorted(live), min(5, len(live))):
        assert np.asarray(db.get_vector(u), np.float32).tobytes() == live[u].tobytes()
    # then the lockstep sequence on a fresh pair
    db.jax = db.port = None
    gc.collect()
    db = _sharded_lockstep(tmp_path / "seq", which)
    ran = run_sequence(db, seed, N_OPS, sharded=True, bulk=300,
                       reopen_at=(N_OPS // 2, 3 * N_OPS // 4))
    assert ran["reopen"] == 2 and ran["raised"], ran
    assert sorted(db.unique_ids) == sorted(db.port.unique_ids)
