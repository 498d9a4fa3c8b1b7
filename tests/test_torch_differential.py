"""Lockstep differential sweep of VectorDatabase: the port
(minivectordb_tpu_torch, device="cpu") against the JAX package on one seeded
op sequence each (tests/_differential.py: stores, batch stores, deletes,
get_vector, single / batch / per-query-filter / async searches with
test_filter_fuzz's filters, error probes, persist_to_disk and a reopen on the
package's own file and on the other package's), for every device_dtype and,
for float32 and mixed, both of the port's small-batch routes (the host BLAS
scan, and the device scan with the host route switched off). A bulk load
takes the capacity to 4,096, so batches of 9 and more (padded to 16) take the
fused route and smaller ones the host scan or ops/scan.py; before it k
exceeds the live count. Counters on the port's scan entry points show which
routes each sequence took. index="ivf" is tests/test_torch_differential_ivf.py.

Tolerances: scores within 2e-5 for float32 and mixed (float32 sums in
another order), 1e-5 for bfloat16 and int8 (tests/test_torch_vector_database.py:
both sum exact products); ids equal where the scores are not tied within the
tolerance; metadata equal. For float32 and mixed the port is also held to
the exact numpy oracle at every search, and the oracle decides a
divergence (tests/_differential.py). Seeds: SEEDS per configuration, sized
so the file runs in about a minute serially on a CPU.
"""

import pytest

import minivectordb_tpu.core.store as jax_store
import minivectordb_tpu_torch.core.store as port_store

from _differential import count_calls, flat_lockstep, run_sequence

SEEDS = [0, 1, 2]
N_OPS = 90
TOL = {"float32": 2e-5, "mixed": 2e-5, "bfloat16": 1e-5, "int8": 1e-5}
FLAT = [("float32", "host"), ("float32", "device"), ("mixed", "host"),
        ("mixed", "device"), ("bfloat16", "device"), ("int8", "device")]


def route_counts(monkeypatch) -> dict:
    """Calls of the port's scan routes from here on: the host BLAS scan, the
    plain device scan (ops/scan.py) and the fused scan (ops/fused_scan.py)."""
    scan, fused = port_store.scan_ops, port_store.fused_scan
    return count_calls(monkeypatch, {
        "host": [(port_store.StoreSnapshot, "_host_search")],
        "scan": [(scan, "scan_topk"), (scan, "scan_topk_int8")],
        "fused": [(fused, "fused_scan_topk"), (fused, "fused_scan_topk_int8")]})


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype,route", FLAT, ids=[f"{d}-{r}" for d, r in FLAT])
def test_flat_lockstep(tmp_path, monkeypatch, dtype, route, seed):
    if route == "device":
        monkeypatch.setattr(port_store, "_HOST_SCAN_MAX_BYTES", 0)
        monkeypatch.setattr(jax_store, "_HOST_SCAN_MAX_BYTES", 0)
    routes = route_counts(monkeypatch)
    # float32 and mixed answer exact float32 scores: an oracle can decide
    oracle = dtype in ("float32", "mixed")
    db = flat_lockstep(tmp_path, TOL[dtype], oracle=oracle, device_dtype=dtype)
    ran = run_sequence(db, seed, N_OPS, sharded=False, reopen_at=(N_OPS // 2, 3 * N_OPS // 4))
    assert ran["fused_batch"] and ran["reopen"] == 2 and ran["raised"], ran
    # batches of 9 and more pad to 16 and take the fused route; smaller
    # ones the host scan, or with the host route off ops/scan.py
    assert routes["fused"] and (routes["host"] if route == "host" else routes["scan"]), routes
    assert bool(routes["host"]) == (route == "host"), routes
