"""parallel/dist_scan.py and parallel/mesh.py of the port against the JAX
package's on the 8 virtual CPU devices of tests/conftest.py.

The port runs on ``device="cpu"`` meshes: n logical shards of the host, each
with its own row block (search_mesh(n, device="cpu")), the emulation the JAX
tests get from XLA's forced host device count. The same seeded numpy inputs
go through both packages. Tolerances: ids equal where scores are not tied;
scores within 1e-5 for float32 (float32 sums in another order), 2e-2 for
bfloat16 (the rows are the same bf16 values; the two packages may round the
query to bf16 at another point of the chain), and int8 candidate sets
exactly (integer dots, the same two float32 scales)."""

import numpy as np
import pytest
import torch

import jax

from minivectordb_tpu.parallel import dist_scan as jdist
from minivectordb_tpu.parallel import mesh as jmesh
from minivectordb_tpu_torch.core.engine import SearchEngine as TorchEngine
from minivectordb_tpu_torch.core.store import VectorStore as TorchStore
from minivectordb_tpu_torch.parallel import dist_scan as tdist
from minivectordb_tpu_torch.parallel import mesh as tmesh
from minivectordb_tpu_torch.vector_database import VectorDatabase as TorchDB

ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 1e-5}
MASKED = -1.0e38


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _oracle(mat, q, k, keep=None):
    s = _norm(q) @ _norm(mat).T
    if keep is not None:
        s[:, ~keep] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k], s


def _same(tv, ti, jv, ji, atol):
    """Scores within atol; ids equal where the JAX scores are not tied
    (within 2 * atol of a neighbour); sentinel slots carry no id."""
    tv, ti, jv, ji = map(np.asarray, (tv, ti, jv, ji))
    assert tv.shape == jv.shape and ti.shape == ji.shape
    live = jv > MASKED
    assert np.array_equal(tv > MASKED, live)
    np.testing.assert_allclose(tv[live], jv[live], rtol=0, atol=atol)
    for b, j in zip(*np.nonzero((ti != ji) & live)):
        near = [abs(jv[b, j] - jv[b, i]) for i in (j - 1, j + 1)
                if 0 <= i < jv.shape[1] and live[b, i]]
        assert near and min(near) <= 2 * atol, (b, j, ti[b], ji[b])


def _pair(n_shards, d, dtype, mat, impl="xla"):
    t = tdist.DistributedScanIndex(tmesh.search_mesh(n_shards, device="cpu"), d,
                                   device_dtype=dtype)
    t.load(mat)
    j = jdist.DistributedScanIndex(jmesh.search_mesh(n_shards), d,
                                   device_dtype=dtype, search_impl=impl)
    j.load(mat)
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_distributed_scan_matches_jax_and_oracle(dtype):
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    rng = np.random.default_rng(0)
    n, d, k = 5000, 64, 10
    mat = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((3, d)).astype(np.float32)
    t, j = _pair(8, d, dtype, mat)
    assert t.capacity == j.capacity == 8192 and t.local_rows == 1024
    tv, ti = t.search(queries, k)
    jv, ji = j.search(queries, k)
    _same(tv, ti, jv, ji, ATOL[dtype])
    if dtype == "float32":
        want, s = _oracle(mat, queries, k)
        for b in range(3):
            assert sorted(ti[b]) == sorted(want[b])
            np.testing.assert_allclose(tv[b], s[b, want[b]], rtol=0, atol=1e-5)


def test_distributed_scan_with_mask():
    rng = np.random.default_rng(1)
    n, d = 3000, 32
    mat = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((1, d)).astype(np.float32)
    allowed = rng.choice(n, size=40, replace=False)
    mask = np.zeros(n, dtype=bool)
    mask[allowed] = True
    t, j = _pair(8, d, "float32", mat)
    tv, ti = t.search(q, 5, mask=mask)
    jv, ji = j.search(q, 5, mask=mask)
    _same(tv, ti, jv, ji, 1e-5)
    want, _ = _oracle(mat, q, 5, keep=mask)
    assert ti[0].tolist() == want[0].tolist()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_fused_route_matches_jax_pallas_route(dtype, masked):
    """Row blocks of 4096 and a batch of 16: each shard takes the port's
    fused route (the phase-1 kernels' plain versions on the CPU), held
    against JAX's Pallas route interpreted on the CPU mesh."""
    rng = np.random.default_rng(7)
    n, d, k, b = 7000, 32, 8, 16  # capacity 8192 -> 4096 rows a shard
    mat = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    mask = (rng.random(n) < 0.5) if masked else None
    t, j = _pair(2, d, dtype, mat, impl="pallas")
    snap = t.snapshot()
    assert snap.use_fused(b) and not snap.use_fused(b - 1)
    tv, ti = snap.search(queries, k, mask=mask)
    jv, ji = j.search(queries, k, mask=mask)
    _same(tv, ti, jv, ji, ATOL[dtype])
    if dtype == "int8":
        assert [set(r) for r in ti] == [set(r) for r in np.asarray(ji)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_route_matches_jax_xla_route(dtype):
    """512 rows a shard and a batch of 4: the plain per-shard scan, held
    against JAX's XLA route, with and without a mask."""
    rng = np.random.default_rng(7)
    n, d, k = 3000, 32, 8  # capacity 4096 -> 512 local rows per device
    mat = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((4, d)).astype(np.float32)
    mask = rng.random(n) < 0.5
    t, j = _pair(8, d, dtype, mat)
    assert not t.snapshot().use_fused(16)  # 512-row blocks: plain at any batch
    for m in (None, mask):
        tv, ti = t.search(queries, k, mask=m)
        jv, ji = j.search(queries, k, mask=m)
        _same(tv, ti, jv, ji, ATOL[dtype])


def test_pod_mesh_hierarchical_scan_matches_jax_and_oracle():
    """2-D (dcn, ici) pod mesh of 2 hosts x 4 devices in one process: each
    host's shards merge first, then the hosts' lists."""
    mesh = tmesh.pod_mesh(2, 4, device="cpu")
    assert mesh.devices.shape == (2, 4) and mesh.axis_names == ("dcn", "ici")
    assert not mesh.distributed
    rng = np.random.default_rng(11)
    n, d, k = 4000, 48, 12
    mat = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((3, d)).astype(np.float32)
    mask = rng.random(n) < 0.4
    t = tdist.DistributedScanIndex(mesh, d)
    t.load(mat)
    j = jdist.DistributedScanIndex(jmesh.pod_mesh(2, 4), d)
    j.load(mat)
    for m in (None, mask):
        tv, ti = t.search(queries, k, mask=m)
        jv, ji = j.search(queries, k, mask=m)
        _same(tv, ti, jv, ji, 1e-5)
        want, _ = _oracle(mat, queries, k, keep=m)
        for b in range(3):
            assert sorted(ti[b]) == sorted(want[b])


def test_pod_mesh_incremental_update():
    mesh = tmesh.pod_mesh(2, 4, device="cpu")
    rng = np.random.default_rng(12)
    idx = tdist.DistributedScanIndex(mesh, 16)
    base = rng.standard_normal((512, 16)).astype(np.float32)
    idx.load(base)
    extra = rng.standard_normal((8, 16)).astype(np.float32)
    idx.update(extra, 512, 520)
    vals, ids = idx.search(extra[3][None, :], 1)
    assert ids[0, 0] == 515


def test_dist_snapshot_survives_concurrent_update():
    """A snapshot keeps the tensors it was taken on: an update while it is
    alive writes copies (tests/test_core_ops.py:207)."""
    mesh = tmesh.search_mesh(8, device="cpu")
    rng = np.random.default_rng(5)
    idx = tdist.DistributedScanIndex(mesh, 16)
    base = rng.normal(size=(128, 16)).astype(np.float32)
    idx.load(base)
    snap = idx.snapshot()
    before = [b.clone() for b in snap.bufs]
    idx.update(rng.normal(size=(8, 16)).astype(np.float32), 128, 136)
    vals, ids = snap.search(base[5][None, :], 1)
    assert ids[0, 0] == 5
    assert all(torch.equal(a, b) for a, b in zip(before, snap.bufs))
    # no snapshot alive: the next update writes in place
    del snap
    bufs = list(idx._bufs)
    idx.update(rng.normal(size=(8, 16)).astype(np.float32), 136, 144)
    assert all(a is b for a, b in zip(bufs, idx._bufs))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_mesh_load_update_host_quantized(dtype):
    """Mesh blocks built from the host quantizers hold the single-device
    store's stored bytes, agree with it and with JAX's mesh index, and track
    updates (tests/test_scale_upload.py:135)."""
    rng = np.random.default_rng(13)
    n, d, k = 4000, 32, 10
    mat = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    t, j = _pair(8, d, dtype, mat)
    store = TorchStore(d, device_dtype=dtype, device="cpu")
    store.append(mat)
    buf, inv, _ = store.sync()
    lr = t.local_rows
    for s, (tb, ti) in enumerate(zip(t._bufs, t._invs)):
        live = max(0, min(n - s * lr, lr))
        assert torch.equal(tb[:live], buf[s * lr:s * lr + live])
        assert torch.equal(ti[:live], inv[s * lr:s * lr + live])
    dv, di = t.search(q, k)
    sv, si = store.search(q, k)
    np.testing.assert_allclose(np.sort(dv, -1), np.sort(sv, -1), rtol=1e-5, atol=1e-6)
    for b in range(3):
        assert len(set(di[b]) & set(si[b])) >= k - 1
    jv, ji = j.search(q, k)
    _same(dv, di, jv, ji, ATOL[dtype])
    # dirty-range update: 50 rows of a known strong match, across a block edge
    upd = np.tile(q[0] / np.linalg.norm(q[0]), (50, 1)).astype(np.float32)
    t.update(upd, lr - 20, n)
    j.update(upd, lr - 20, n)
    uv, ui = t.search(q[:1], 5)
    assert all(lr - 20 <= r < lr + 30 for r in ui[0])
    jv, ji = j.search(q[:1], 5)
    np.testing.assert_allclose(uv, np.asarray(jv), rtol=0, atol=ATOL[dtype])


def test_dist_scan_snapshot_refs_pruned_on_reads():
    mesh = tmesh.search_mesh(8, device="cpu")
    mat = np.random.default_rng(22).standard_normal((256, 32)).astype(np.float32)
    scan = tdist.DistributedScanIndex(mesh, 32)
    scan.load(mat)
    for _ in range(25):
        scan.snapshot().search(mat[:2], 5)
    assert len(scan._snap_refs) <= 2


def test_shards_past_count_return_sentinels_only():
    """A corpus smaller than one shard: every other shard scans nothing and
    gives sentinels; the merge still returns min(k, count) live hits, and a
    mask that passes nothing returns sentinels only."""
    mesh = tmesh.search_mesh(8, device="cpu")
    rng = np.random.default_rng(3)
    mat = rng.standard_normal((40, 8)).astype(np.float32)
    t, j = _pair(8, 8, "float32", mat)
    tv, ti = t.search(mat[:2], 64)
    jv, ji = j.search(mat[:2], 64)
    assert (tv > MASKED).sum(axis=1).tolist() == [40, 40]
    _same(tv, ti, jv, ji, 1e-5)
    assert set(ti[0][tv[0] > MASKED]) == set(range(40))
    tv, _ = t.search(mat[:2], 5, mask=np.zeros(40, dtype=bool))
    assert (tv <= MASKED).all()
    assert mesh.local_shards()[3] == (3, torch.device("cpu"))


@pytest.mark.parametrize("n_rows,k", [(40, 64), (8, 16)])
def test_mesh_small_corpus_large_k_exact_count(n_rows, k, tmp_path):
    """k larger than a shard's rows: the merged top-k still returns
    min(k, count) (tests/test_fastpath.py:163)."""
    db = TorchDB(storage_file=str(tmp_path / "k.pkl"),
                 mesh=tmesh.search_mesh(8, device="cpu"))
    rng = np.random.default_rng(2)
    mat = rng.standard_normal((n_rows, 8)).astype(np.float32)
    db.store_embeddings_batch(list(range(n_rows)), mat)
    ids, scores, metas = db.find_most_similar(mat[0], k=k)
    assert len(ids) == min(k, n_rows)
    assert ids[0] == 0


def test_mesh_incremental_sync_no_full_reupload(tmp_path):
    """A mutation between searches ships only the dirty slab to the mesh,
    not the corpus (tests/test_fastpath.py:180)."""
    db = TorchDB(storage_file=str(tmp_path / "i.pkl"),
                 mesh=tmesh.search_mesh(8, device="cpu"))
    rng = np.random.default_rng(3)
    n, d = 4000, 64  # below the 4096 capacity bucket: inserts fit in place
    mat = rng.standard_normal((n, d)).astype(np.float32)
    db.store_embeddings_batch(list(range(n)), mat)
    db.find_most_similar(mat[0], k=3)  # initial full load
    dist = db._engine._dist
    base_bytes = dist.bytes_uploaded
    assert base_bytes >= n * d * 4

    db.store_embedding(n + 1, np.ones(d, np.float32))
    ids, _, _ = db.find_most_similar(np.ones(d, np.float32), k=2)
    assert ids[0] == n + 1
    delta = dist.bytes_uploaded - base_bytes
    assert delta <= 64 * d * 4, f"mutation re-shipped {delta} bytes"

    base_bytes = dist.bytes_uploaded
    db.delete_embedding(n - 10)  # near the tail: small dirty suffix
    ids2, _, _ = db.find_most_similar(mat[5], k=3)
    assert ids2[0] == 5
    delta = dist.bytes_uploaded - base_bytes
    assert delta <= 64 * d * 4, f"delete re-shipped {delta} bytes"


def test_mesh_int8_parity_with_single_device_and_jax():
    """int8 on the mesh returns the single-device int8 engine's rows, and
    JAX's mesh engine's (tests/test_fastpath.py:217)."""
    from minivectordb_tpu.core.engine import SearchEngine as JaxEngine

    rng = np.random.default_rng(4)
    n, d = 2048, 32
    mat = rng.standard_normal((n, d)).astype(np.float32)
    single = TorchEngine(device_dtype="int8", device="cpu")
    meshed = TorchEngine(device_dtype="int8", mesh=tmesh.search_mesh(8, device="cpu"))
    jmeshed = JaxEngine(device_dtype="int8", mesh=jmesh.search_mesh(8))
    for e in (single, meshed, jmeshed):
        e.load(mat, list(range(n)), [{} for _ in range(n)])
    q = rng.standard_normal((4, d)).astype(np.float32)
    rs = single.search_batch(q, k=10, return_distances=True)
    rm = meshed.search_batch(q, k=10, return_distances=True)
    rj = jmeshed.search_batch(q, k=10, return_distances=True)
    for (ids_s, d_s, _), (ids_m, d_m, _), (ids_j, d_j, _) in zip(rs, rm, rj):
        assert list(ids_s) == list(ids_m) == list(ids_j)
        np.testing.assert_allclose(np.asarray(d_s), np.asarray(d_m), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(d_j), np.asarray(d_m), rtol=1e-5, atol=1e-5)


def test_mesh_constructors():
    m = tmesh.search_mesh(3, device="cpu")
    assert m.devices.shape == (3,) and m.axis_names == (tmesh.SHARD_AXIS,)
    assert tmesh.search_mesh(device="cpu").devices.size == 1
    p = tmesh.pod_mesh(2, 2, device="cpu")
    assert [s for s, _ in p.local_shards()] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="n_hosts is required"):
        tmesh.pod_mesh(device="cpu")
    t = tmesh.train_mesh(2, device="cpu")  # item 13b: the (dp, tp) mesh, tp halved to fit
    assert t.devices.shape == (1, 2) and t.axis_names == (tmesh.DP_AXIS, tmesh.TP_AXIS)
    assert tmesh.train_mesh(3, tp=2, device="cpu").devices.shape == (3, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.search_mesh()
    with pytest.raises(ValueError):
        tdist.DistributedScanIndex(m, 8, device_dtype="float16")
    assert tdist.DistributedScanIndex(m, 8, device_dtype="mixed").device_dtype == "float32"
    # an odd mesh rounds the capacity up to a multiple of its size
    idx = tdist.DistributedScanIndex(m, 8)
    idx.load(np.ones((10, 8), np.float32))
    assert idx.capacity % 3 == 0 and idx.capacity >= 1024
