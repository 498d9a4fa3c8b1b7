"""core/store.py of the PyTorch port against minivectordb_tpu.core.store on the
CPU. The JAX store takes its Pallas route (kernels interpreted) through
MINIVECTORDB_TPU_FORCE_PALLAS, so batches of 16 and more run the fused route
on both sides. Tolerances: ids equal, scores atol 1e-5 (int8 1e-6)."""

import gc

import numpy as np
import pytest
import torch

from minivectordb_tpu.core import store as jstore
from minivectordb_tpu_torch.core import store as tstore
from minivectordb_tpu_torch.ops import fused_scan as tfused

DTYPES = ["float32", "bfloat16", "mixed", "int8"]


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("MINIVECTORDB_TPU_FORCE_PALLAS", "1")


def _pair(dim, dtype):
    return (jstore.VectorStore(dim, dtype),
            tstore.VectorStore(dim, dtype, device="cpu"))


def _same(j_out, t_out, dtype="float32"):
    jv, jx = j_out
    tv, tx = t_out
    np.testing.assert_array_equal(np.asarray(tx), np.asarray(jx))
    np.testing.assert_allclose(
        np.asarray(tv), np.asarray(jv), rtol=0,
        atol=1e-6 if dtype == "int8" else 1e-5,
    )


def test_constants_and_device_argument():
    assert tstore._HOST_ALWAYS_BYTES == jstore._HOST_ALWAYS_BYTES == 8 << 20
    assert tstore._HOST_SCAN_MAX_BATCH == jstore._HOST_SCAN_MAX_BATCH == 8
    assert tstore._HOST_SCAN_MAX_BYTES == 1024 << 20
    assert tstore._POW2_PAD_MAX_BATCH == jstore._POW2_PAD_MAX_BATCH
    assert tstore._MIN_CAPACITY == jstore._MIN_CAPACITY
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tstore.VectorStore(8)
    with pytest.raises(ValueError):
        tstore.VectorStore(8, "float16", device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_append_sync_dirty_range(dtype):
    """Device buffers after a full upload, an incremental (dirty range) sync
    and a capacity change hold the JAX store's values."""
    rng = np.random.default_rng(0)
    js, ts = _pair(24, dtype)
    for n in (700, 90, 1, 400):  # 400 crosses the 1024 bucket -> full upload
        rows = rng.standard_normal((n, 24)).astype(np.float32)
        assert js.append(rows) == ts.append(rows)
        assert js.pending_upload_rows() == ts.pending_upload_rows()
        jb, ji, jc = js.sync()
        tb, ti, tc = ts.sync()
        assert jc == tc and ts._dev_capacity == js._dev_capacity
        assert ts._dirty_from == js._dirty_from == tc
        live = slice(0, tc)
        np.testing.assert_array_equal(
            tb[live].to(torch.float32).numpy(),
            np.asarray(jb[live].astype(np.float32)),
        )
        np.testing.assert_allclose(
            ti[live].numpy(), np.asarray(ji[live]), rtol=1e-6
        )
        if dtype == "mixed":
            np.testing.assert_array_equal(
                ts._scan_buf[live].to(torch.float32).numpy(),
                np.asarray(js._scan_buf[live].astype(np.float32)),
            )
    np.testing.assert_array_equal(ts.view(), js.view())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [3, 32])
def test_device_route_matches_jax(force_pallas, dtype, batch):
    rng = np.random.default_rng(1)
    n, d, k = 6000, 32, 10
    mat = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((batch, d)).astype(np.float32)
    mask = rng.random(n) < 0.4
    js, ts = _pair(d, dtype)
    js.append(mat), ts.append(mat)
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    assert tsnap._use_fused("exact", 32) and not tsnap._use_fused("exact", 8)
    for mode in ("exact", "approx"):
        for m in (None, mask):
            _same(jsnap._device_search(q, k, m, mode),
                  tsnap._device_search(q, k, m, mode), dtype)


def test_host_route_and_device_route_agree():
    rng = np.random.default_rng(2)
    n, d, k = 3000, 16, 7
    mat = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((4, d)).astype(np.float32)
    mask = rng.random(n) < 0.5
    js, ts = _pair(d, "float32")
    js.append(mat), ts.append(mat)
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    assert tsnap._host_eligible("exact", 4) and not tsnap._host_eligible("exact", 9)
    assert not tsnap._host_eligible("approx", 1)
    for m in (None, mask):
        host = tsnap._host_search(q, k, m)
        _same(jsnap._host_search(q, k, m), host)
        _same(host, tsnap._device_search(q, k, m))
        # a corpus this small is always served by the host route
        _same(host, tsnap.search(q, k, m))
    assert ts.router.n == 0


def test_router_times_device_in_line(monkeypatch):
    """Past the always-host size the router primes the host, then times the
    device on the caller's thread; a device error reaches the caller."""
    monkeypatch.setattr(tstore, "_HOST_ALWAYS_BYTES", 0)
    rng = np.random.default_rng(3)
    mat = rng.standard_normal((2000, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    ts = tstore.VectorStore(16, device="cpu")
    ts.append(mat)
    want = ts.snapshot()._host_search(q, 5, None)
    for i in range(tstore._ROUTER_FIRST_PROBE + 2):
        _same(want, ts.search(q, 5))
    r = ts.router
    assert r.host_ema is not None and r.dev_ema is not None
    assert r.n == tstore._ROUTER_FIRST_PROBE + 2

    snap = ts.snapshot()
    r.host_ema, r.dev_ema = 1.0, 1e-9  # device is "faster" from here on

    def boom(*a, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tstore.scan_ops, "scan_topk", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        snap.search(q, 5)


def test_router_choose_sequence():
    r = tstore._ScanRouter()
    assert r.choose() == "host"
    r.record("host", 0.010)
    seq = [r.choose() for _ in range(tstore._ROUTER_FIRST_PROBE)]
    assert seq[:-1] == ["host"] * (tstore._ROUTER_FIRST_PROBE - 1)
    assert seq[-1] == "device"
    r.record("device", 0.002)
    assert r.choose() == "device"
    r.record("device", 0.004)
    assert abs(r.dev_ema - (0.7 * 0.002 + 0.3 * 0.004)) < 1e-12
    r.n = tstore._ROUTER_REFRESH_EVERY - 1
    assert r.choose() == "host"  # periodic re-timing of the slower path


@pytest.mark.parametrize("dtype", ["float32", "mixed", "int8"])
def test_tombstone_and_compact(force_pallas, dtype):
    rng = np.random.default_rng(4)
    n, d, k = 5000, 16, 6
    mat = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    js, ts = _pair(d, dtype)
    js.append(mat), ts.append(mat)
    js.sync(), ts.sync()
    dead = sorted(rng.choice(n, size=300, replace=False).tolist())
    assert js.tombstone_rows(dead[:100]) == ts.tombstone_rows(dead[:100]) == 100
    js.sync(), ts.sync()  # builds the device alive mask
    assert js.tombstone_rows(dead[50:]) == ts.tombstone_rows(dead[50:]) == 200
    assert ts.live_count == js.live_count == n - 300
    np.testing.assert_array_equal(ts.alive_host, js.alive_host)
    np.testing.assert_array_equal(ts.dead_rows(), js.dead_rows())
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    np.testing.assert_array_equal(
        tsnap.alive_dev.numpy(), np.asarray(jsnap.alive_dev)
    )
    jo = jsnap.search(q, k) if dtype != "int8" else jsnap._device_search(
        q, k, jsnap.host_alive, mask_dev=jsnap.alive_dev)
    to = tsnap.search(q, k)
    _same(jo, to, dtype)
    assert not set(np.asarray(to[1]).ravel().tolist()) & set(dead)

    del jsnap, tsnap
    gc.collect()
    np.testing.assert_array_equal(ts.compact_dead(), js.compact_dead())
    assert ts.count == js.count == n - 300 and ts.dead_count == 0
    assert ts._dirty_from == js._dirty_from  # the device gather kept it current
    np.testing.assert_array_equal(ts.view(), js.view())
    _same(js.snapshot()._device_search(q, k), ts.snapshot()._device_search(q, k), dtype)
    _same(js.snapshot()._device_search(q[:2], k), ts.snapshot()._device_search(q[:2], k), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_snapshot_isolation_under_in_place_writes(dtype):
    """Take a snapshot, mutate the store, sync, search the old snapshot: it
    still answers from the old rows. Without a live snapshot the sync writes
    in place; with one it writes a clone and swaps."""
    rng = np.random.default_rng(5)
    d, k = 16, 3
    mat = rng.standard_normal((1500, d)).astype(np.float32)
    ts = tstore.VectorStore(d, dtype, device="cpu")
    ts.append(mat)  # capacity bucket 2048: room to grow without a re-upload
    probe = mat[[1400]]

    ts.sync()
    buf_before = ts._buf
    ts.append(rng.standard_normal((10, d)).astype(np.float32))
    ts.sync()
    assert ts._buf is buf_before, "no live snapshot: the update is in place"

    snap = ts.snapshot()
    old = snap._device_search(probe, k)
    old_buf = snap.buf.clone()
    extra = np.tile(probe, (40, 1)) * 3.0  # 40 rows that would all outrank
    ts.append(extra)
    ts.replace_row(1400, -probe[0])  # and the old best hit changes sign
    ts.sync()
    assert ts._buf is not snap.buf, "a live snapshot forces copy-on-write"
    assert torch.equal(snap.buf, old_buf)
    again = snap._device_search(probe, k)
    np.testing.assert_array_equal(again[1], old[1])
    np.testing.assert_array_equal(again[0], old[0])
    assert old[1][0][0] == 1400
    host_old = snap._host_search(probe, k, None)
    assert host_old[1][0][0] == 1400  # the host mirror was copied on write too
    new = ts.snapshot()._device_search(probe, k)
    assert (new[1][0] >= 1510).all() and 1400 not in new[1][0].tolist()

    # tombstones never touch a captured alive mask
    ts.tombstone_rows([0, 1])
    s1 = ts.snapshot()
    alive1 = s1.alive_dev.clone()
    ts.tombstone_rows([2, 3])
    assert torch.equal(s1.alive_dev, alive1) and ts._alive_dev is not s1.alive_dev


def test_tensor_queries_pass_through():
    rng = np.random.default_rng(6)
    mat = rng.standard_normal((5000, 16)).astype(np.float32)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    ts = tstore.VectorStore(16, device="cpu")
    ts.append(mat)
    want = ts.search(q, 5)
    got = ts.search(torch.from_numpy(q), 5)
    _same(want, got)
    deferred = ts.snapshot().search(torch.from_numpy(q), 5, fetch=False)
    assert isinstance(deferred[0], torch.Tensor)
    assert deferred[0].shape == (20, 5) and deferred[1].dtype == torch.int32
    one = ts.search(torch.from_numpy(q[0]), 5)  # 1-D tensor: one query
    _same((want[0][:1], want[1][:1]), one)


def test_batch_padding_shapes(monkeypatch):
    """Batches reach the scan functions padded as in the JAX store: a power
    of two >= 8 up to 256, a multiple of 256 above."""
    seen = []
    real = tfused.fused_scan_topk

    def spy(buf, inv, q, *a, **kw):
        seen.append(q.shape[0])
        return real(buf, inv, q, *a, **kw)

    monkeypatch.setattr(tstore.fused_scan, "fused_scan_topk", spy)
    rng = np.random.default_rng(7)
    ts = tstore.VectorStore(8, device="cpu")
    ts.append(rng.standard_normal((4096, 8)).astype(np.float32))
    snap = ts.snapshot()
    for b in (16, 17, 100, 256, 257):
        out = snap._device_search(rng.standard_normal((b, 8)).astype(np.float32), 4)
        assert out[0].shape == (b, 4)
    assert seen == [16, 32, 128, 256, 512]


def test_load_resets_and_release_device():
    rng = np.random.default_rng(8)
    ts = tstore.VectorStore(8, device="cpu")
    ts.append(rng.standard_normal((100, 8)).astype(np.float32))
    ts.tombstone_rows([1])
    snap = ts.snapshot()
    fresh = rng.standard_normal((50, 8)).astype(np.float32)
    ts.load(fresh)
    assert ts.count == 50 and ts.dead_count == 0 and ts._buf is None
    assert snap.count == 100  # the old snapshot keeps its own arrays
    assert ts.search(fresh[[7]], 1)[1][0][0] == 7
    ts.release_device()
    assert ts._buf is None and ts.pending_upload_rows() == 50
    assert ts.search(fresh[[9]], 1)[1][0][0] == 9


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_eager_delete_rows_and_replace_row(dtype):
    rng = np.random.default_rng(9)
    mat = rng.standard_normal((1200, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    js, ts = _pair(16, dtype)
    js.append(mat), ts.append(mat)
    js.sync(), ts.sync()
    gone = [5, 700, 701, 1199]
    js.delete_rows(gone), ts.delete_rows(gone)
    new_row = rng.standard_normal(16).astype(np.float32)
    js.replace_row(3, new_row), ts.replace_row(3, new_row)
    assert ts.count == js.count == 1196 and ts._dirty_from == js._dirty_from == 3
    np.testing.assert_array_equal(ts.view(), js.view())
    _same(js.snapshot()._device_search(q, 5), ts.snapshot()._device_search(q, 5), dtype)
