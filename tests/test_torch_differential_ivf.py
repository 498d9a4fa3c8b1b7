"""Lockstep differential sweep of VectorDatabase(index="ivf"): the port
(device="cpu") against the JAX package on tests/_differential.py's seeded op
sequence (stores, batch stores, deletes past the build, get_vector, single /
batch / per-query-filter / async searches with test_filter_fuzz's filters,
error probes, persist_to_disk and reopens on the package's own file and on
the other package's, whose pickle carries the trained layout across), with
bfloat16, float32 and int8 lists. nlist = 8 and nprobe = nlist: the two
packages' k-means train other centroids from one seed, and only an
exhaustive probe gives answers that do not depend on the layout. The index
builds at 256 rows and rebuilds under churn.

Tolerance: scores within 2e-5 (float32 sums in another order; quantized
lists are rescored in float32), ids equal where the scores are not tied
within it, metadata equal. The port is held to the exact numpy oracle at
every search too, and where the packages diverge the oracle decides: a JAX
answer that misses it is the reference's fault and passes (one is below), a
port answer that misses it fails. Seeds: SEEDS per lists type, sized so the
file runs in about a minute serially on a CPU.

A fault of the reference that the port had copied, found by the sweep (F6 in
ROADMAP.md, now fixed in the port): rows deleted from a reopened database
before its persisted IVF layout reattaches stay in the layout (the engine
tombstoned only rows below its built count, which is 0 until the attach), so
every later search could return them.
test_deletes_before_the_layout_reattaches_are_not_served pins the port's
behaviour.
"""

import numpy as np
import pytest

from minivectordb_tpu.sharded_vector_database import ShardedVectorDatabase as JaxSDB
from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import ShardedVectorDatabase, VectorDatabase

from _differential import flat_lockstep, run_sequence

SEEDS = [0, 1, 2]
N_OPS = 90
NLIST = 8
IVF_OPTS = {"build_threshold": 256, "iters": 4, "rebuild_frac": 0.3, "rebuild_floor": 64}
BATCHES = (2, 12, 16)  # each batch shape is a JAX program to compile


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lists_dtype", ["bfloat16", "float32", "int8"])
def test_ivf_lockstep(tmp_path, lists_dtype, seed):
    db = flat_lockstep(tmp_path, 2e-5, oracle=True, index="ivf", nlist=NLIST, nprobe=NLIST,
                   ivf_opts={**IVF_OPTS, "lists_dtype": lists_dtype})
    ran = run_sequence(db, seed, N_OPS, sharded=False, reopen_at=(N_OPS // 2, 3 * N_OPS // 4),
                       batch_sizes=BATCHES)
    assert ran["reopen"] == 2 and ran["raised"], ran
    for side in (db.jax, db.port):
        ivf = side.stats()["ivf"]
        assert ivf["built"] and ivf["indexed_rows"] > 2048, ivf


def _reopened_with_deletes(tmp_path, cls, lists_dtype, **kw):
    """An IVF database of 2,300 rows, built, persisted and reopened (its
    layout pending reattach), then 3 rows deleted before any search.
    Returns (database, rows, deleted ids)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    rows = np.random.default_rng(0).standard_normal((2300, 16)).astype(np.float32)
    opts = {**IVF_OPTS, "lists_dtype": lists_dtype}
    if cls in (VectorDatabase, JaxDB):
        def open_db():
            return cls(storage_file=str(tmp_path / "db.pkl"), index="ivf", nlist=NLIST,
                       nprobe=NLIST, ivf_opts=opts, **kw)
    else:
        def open_db():
            return cls(storage_dir=str(tmp_path / "shards"), shard_size=512, index="ivf",
                       ivf_opts={**opts, "nlist": NLIST, "nprobe": NLIST}, **kw)
    db = open_db()
    db.store_embeddings_batch(list(range(len(rows))), rows)
    db.find_most_similar(rows[0], k=3)  # builds the layout
    if hasattr(db, "persist_to_disk"):
        db.persist_to_disk()
    del db
    db = open_db()
    assert db.stats()["ivf"]["pending_attach"]
    doomed = [5, 700, 1500]
    if hasattr(db, "delete_embeddings_batch"):
        db.delete_embeddings_batch(doomed)
    else:
        for u in doomed:
            db.delete_embedding(u)
    return db, rows, doomed


@pytest.mark.parametrize("cls", ["flat", "sharded"])
@pytest.mark.parametrize("lists_dtype", ["bfloat16", "float32", "int8"])
def test_deletes_before_the_layout_reattaches_are_not_served(tmp_path, cls, lists_dtype):
    """Seed 29's sequence (bfloat16 lists) showed it first: after the
    reopen, delete_embedding(283), (440), (2181) ran before the layout
    reattached, and 42 ops later an unfiltered batch of 24 returned 283 in
    both packages. Here: a row's own vector as the query, k = 3, after its
    delete. The JAX package answers [5, 1548, 1039] for row 5 (the deleted
    row first); the port must answer the exact top 3 of the live rows
    ([1548, 1039, 696])."""
    port_cls, jax_cls = {"flat": (VectorDatabase, JaxDB),
                         "sharded": (ShardedVectorDatabase, JaxSDB)}[cls]
    db, rows, doomed = _reopened_with_deletes(tmp_path / "port", port_cls, lists_dtype,
                                              device="cpu")
    live = np.delete(np.arange(len(rows)), doomed)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    want = [live[np.argsort(-(unit[live] @ unit[u]), kind="stable")[:3]].tolist()
            for u in doomed]
    got = [list(db.find_most_similar(rows[u], k=3)[0]) for u in doomed]
    assert got == want
    assert [list(h[0]) for h in db.find_most_similar_batch(rows[doomed], k=3)] == want
    assert db.stats()["ivf"]["built"] and db.stats()["ivf"]["dead_slots"] == len(doomed)
    # the reference's answer, for the record: the deleted rows come back
    jdb, _, _ = _reopened_with_deletes(tmp_path / "jax", jax_cls, lists_dtype)
    jax_hits = [list(jdb.find_most_similar(rows[u], k=3)[0]) for u in doomed]
    assert [h[0] for h in jax_hits] == doomed
    # after a persist (compaction) and a reopen the port still serves the live rows
    if hasattr(db, "persist_to_disk"):
        db.persist_to_disk()
        db = port_cls(storage_file=db.storage_file, index="ivf", nlist=NLIST, nprobe=NLIST,
                      ivf_opts={**IVF_OPTS, "lists_dtype": lists_dtype}, device="cpu")
        assert [list(db.find_most_similar(rows[u], k=3)[0]) for u in doomed] == want
