"""Lockstep differential sweep of mesh= search: the port's VectorDatabase on
search_mesh(4, device="cpu") (4 logical shards of the host) against the JAX
package's VectorDatabase on a mesh of 4 of its 8 virtual CPU devices
(tests/conftest.py), on tests/_differential.py's seeded op sequence (stores,
batch stores, deletes, get_vector, single / batch / per-query-filter /
async searches with test_filter_fuzz's filters, error probes, persist_to_disk
and reopens on the package's own file and on the other package's, each
reopened on its mesh), for float32, bfloat16 and int8, and for
ShardedVectorDatabase(mesh=...) with durability "wal". The bulk load takes
each shard's block to 4,096 rows, so batches of 16 and more take the fused
route per shard (counted).

Tolerances: as tests/test_torch_differential.py (float32 2e-5, bfloat16 and
int8 1e-5); ids equal where the scores are not tied; metadata equal; in
float32 the port is held to the exact numpy oracle at every search, and the
oracle decides a divergence. Seeds:
SEEDS per configuration, sized so the file runs in about a minute serially
on a CPU.
"""

import pytest

from minivectordb_tpu.parallel.mesh import search_mesh as jax_search_mesh
from minivectordb_tpu.sharded_vector_database import ShardedVectorDatabase as JaxSDB
from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import ShardedVectorDatabase, VectorDatabase
from minivectordb_tpu_torch.ops import fused_scan
from minivectordb_tpu_torch.parallel.mesh import search_mesh

from _differential import Lockstep, count_calls, run_sequence

SEEDS = [0, 1]
N_OPS = 64
SHARDS = 4
TOL = {"float32": 2e-5, "bfloat16": 1e-5, "int8": 1e-5}
BATCHES = (5, 16)  # each batch shape is a JAX mesh program to compile


def _mesh_lockstep(tmp_path, dtype) -> Lockstep:
    paths = [str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")]

    def reopen(swap):
        if swap:
            paths.reverse()
        return (JaxDB(storage_file=paths[0], device_dtype=dtype,
                      mesh=jax_search_mesh(SHARDS)),
                VectorDatabase(storage_file=paths[1], device_dtype=dtype,
                               mesh=search_mesh(SHARDS, device="cpu")))

    return Lockstep(*reopen(False), tol=TOL[dtype], reopen=reopen,
                    oracle=dtype == "float32")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", list(TOL))
def test_mesh_lockstep(tmp_path, monkeypatch, dtype, seed):
    fused = count_calls(monkeypatch, {"per_shard": [(fused_scan, "fused_scan_topk"),
                                                    (fused_scan, "fused_scan_topk_int8")]})
    db = _mesh_lockstep(tmp_path, dtype)
    assert db.port._engine.mesh.devices.size == SHARDS
    ran = run_sequence(db, seed, N_OPS, sharded=False, bulk=2 * 4096 + 200,
                       reopen_at=(N_OPS // 2, 3 * N_OPS // 4), batch_sizes=BATCHES)
    assert ran["reopen"] == 2 and ran["raised"], ran
    assert fused["per_shard"] >= SHARDS, fused


@pytest.mark.parametrize("seed", SEEDS)
def test_sharded_mesh_lockstep(tmp_path, seed):
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]

    def reopen(swap):
        if swap:
            dirs.reverse()
        return (JaxSDB(storage_dir=dirs[0], shard_size=64, durability="wal",
                       mesh=jax_search_mesh(SHARDS)),
                ShardedVectorDatabase(storage_dir=dirs[1], shard_size=64, durability="wal",
                                      mesh=search_mesh(SHARDS, device="cpu")))

    db = Lockstep(*reopen(False), tol=2e-5, reopen=reopen, oracle=True)
    ran = run_sequence(db, seed, N_OPS, sharded=True, bulk=300,
                       reopen_at=(N_OPS // 2, 3 * N_OPS // 4), batch_sizes=BATCHES)
    assert ran["reopen"] == 2 and ran["raised"], ran
