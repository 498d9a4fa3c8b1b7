"""minivectordb_tpu_torch/ops/ivf.py against minivectordb_tpu/ops/ivf.py.

Inputs are made from a seed with numpy and go through both packages on the
CPU. The JAX snapshot runs its Pallas route with the kernels interpreted
(``ivf._FORCE_PALLAS_ROUTE``), the route it takes on its accelerator; the
port's wrappers use the kernels' plain versions on CPU tensors. A trained
layout crosses as a state dict (``convert.ivf_state_from_numpy``), because
the two packages draw their k-means start rows from different generators.
Tolerances: scores 2e-5 (summation order over d <= 128 float32 terms), ids
equal where scores are not tied, host tables equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minivectordb_tpu.ops.ivf as jivf
from minivectordb_tpu.ops.scan import row_inv_norms
from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.ops import ivf as tivf

N, D = 3000, 64


def _corpus(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    return rng, rng.standard_normal((n, d)).astype(np.float32)


def _clustered(seed, n, d, centres, noise=0.05, weights=None):
    """Well-separated unit-norm clusters."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centres, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    which = rng.choice(centres, size=n, p=weights)
    x = c[which] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return rng, (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_lloyd_steps_from_the_same_start_rows_match():
    _, data = _clustered(1, 2000, D, 8)
    key = jax.random.PRNGKey(0)
    init = np.asarray(jax.random.choice(key, 2000, shape=(8,), replace=False))
    jc, ja = jivf._kmeans_device(jnp.asarray(data), key, 8, 5)
    tc, ta = tivf._kmeans_device(torch.from_numpy(data), 8, 5, init_idx=init)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(np.linalg.norm(tc.numpy(), axis=1), 1.0, atol=1e-5)


def test_kmeans_start_rows_come_from_the_seed():
    _, data = _clustered(2, 500, 32, 4)
    t = torch.from_numpy(data)
    a, _ = tivf._kmeans_device(t, 4, 3, seed=5)
    b, _ = tivf._kmeans_device(t, 4, 3, seed=5)
    c, _ = tivf._kmeans_device(t, 4, 0, seed=6)
    assert torch.equal(a, b)
    # zero iterations return the start rows themselves: distinct corpus rows
    rows = {tuple(r) for r in data.round(6).tolist()}
    assert all(tuple(r) in rows for r in c.numpy().round(6).tolist())
    assert len({tuple(r) for r in c.numpy().tolist()}) == 4


def test_assign_chunked_crosses_chunk_borders(monkeypatch):
    _, data = _corpus(3, 1000, 16)
    cent = torch.from_numpy(data[:7] / np.linalg.norm(data[:7], axis=1, keepdims=True))
    whole = tivf._assign_chunked(torch.from_numpy(data), cent)
    monkeypatch.setattr(tivf, "_ASSIGN_CHUNK", 96)
    np.testing.assert_array_equal(
        tivf._assign_chunked(torch.from_numpy(data), cent).numpy(), whole.numpy())
    want = np.asarray(jivf._assign_chunked(jnp.asarray(data), jnp.asarray(cent.numpy())))
    np.testing.assert_array_equal(whole.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_scatter_lists_and_slot_norms_match(dtype, monkeypatch):
    rng, data = _corpus(4, 700, 32)
    inv = (1.0 / np.linalg.norm(data, axis=1)).astype(np.float32)
    dest = rng.permutation(1024)[:700].astype(np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    want = jivf._scatter_lists(jnp.asarray(data), jnp.asarray(inv), jnp.asarray(dest),
                               700, 1024, jdt)
    monkeypatch.setattr(tivf, "_SCATTER_CHUNK", 256)  # three pieces
    got = tivf._scatter_lists(
        torch.from_numpy(data), torch.from_numpy(inv),
        torch.from_numpy(dest).long(), 700, 1024, tivf._LISTS_DTYPES[dtype])
    assert got.dtype == tivf._LISTS_DTYPES[dtype]
    np.testing.assert_array_equal(
        got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)))
    if dtype == "int8":
        assert int(got.min()) >= -127
        np.testing.assert_allclose(
            tivf._slot_inv_norms(got).numpy(),
            np.asarray(jivf._slot_inv_norms(want)), rtol=1e-6)


def test_build_on_a_skewed_corpus_splits_like_the_jax_build():
    """Handed the centroids the JAX build trains, the port's build makes the
    same duplicate centroids, the same P and the same lists."""
    w = np.array([0.55, 0.2, 0.1, 0.05, 0.04, 0.03, 0.02, 0.01])
    _, data = _clustered(5, 4000, D, 8, weights=w)
    jidx = jivf.IVFIndex(nlist=8, nprobe=2, iters=4)
    jidx.build(data)
    assert jidx.n_dup > 0  # the corpus is skewed enough to split
    # the centroids JAX's build trained: the same jitted function on the
    # same sample (n <= 100,000 rows, so the sample is the whole corpus)
    dj = jnp.asarray(data)
    sample = jivf._gather_normalized_sample(
        dj, row_inv_norms(dj), jnp.arange(4000, dtype=jnp.int32))
    raw, _ = jivf._kmeans_device(sample, jax.random.PRNGKey(0), 8, 4)

    tidx = tivf.IVFIndex(nlist=8, nprobe=2, iters=4, device="cpu")
    tidx.build(data, centroids=np.asarray(raw))
    assert tidx.n_dup == jidx.n_dup
    assert tidx.pad_len == jidx.pad_len and tidx.pad_len % 128 == 0
    assert tidx.count == jidx.count == 4000
    np.testing.assert_allclose(
        tidx.centroids.numpy(), np.asarray(jidx.centroids), atol=1e-6)
    np.testing.assert_array_equal(
        tidx._list_valid.numpy().sum(axis=1), np.asarray(jidx._list_valid).sum(axis=1))
    np.testing.assert_array_equal(tidx._list_ids.numpy(), np.asarray(jidx._list_ids))
    np.testing.assert_array_equal(tidx._list_valid.numpy(), np.asarray(jidx._list_valid))


def test_own_build_covers_every_row_once_and_nprobe_nlist_is_exact():
    w = np.array([0.6, 0.2, 0.1, 0.1])
    rng, data = _clustered(6, 3000, D, 4, noise=0.3, weights=w)
    idx = tivf.IVFIndex(nlist=12, nprobe=3, iters=4, device="cpu")
    idx.build(data)
    ids = idx._list_ids.numpy()[idx._list_valid.numpy()]
    assert sorted(ids.tolist()) == list(range(3000))
    assert idx.centroids.shape[0] == idx._lists.shape[0]
    assert idx._lists.shape[1] == idx.pad_len and idx.pad_len % 128 == 0
    q = rng.standard_normal((20, D)).astype(np.float32)
    vals, got = idx.search(q, 10, nprobe=12)  # nlist, duplicates included
    s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ data.T
    want = np.argsort(-s, axis=1)[:, :10]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(vals, np.take_along_axis(s, want, 1), atol=2e-5)
    # a single probed cluster still counts DISTINCT clusters: its duplicates
    # ride along (nprobe is scaled by the split factor)
    assert idx.n_dup > 0
    v1, _ = idx.search(q, 10, nprobe=1)
    assert np.isfinite(v1).all()


@pytest.fixture(scope="module")
def carried():
    """One JAX-built index per lists dtype, carried into the port."""
    rng, mat = _corpus(7, N, 128)
    out = {"mat": mat, "rng": rng}
    for dtype in ("float32", "bfloat16", "int8"):
        jidx = jivf.IVFIndex(nlist=16, nprobe=5, iters=4, device_dtype=dtype)
        jidx.build(mat)
        tidx = tivf.IVFIndex.from_state(
            convert.ivf_state_from_numpy(jidx.state_dict()), mat, device="cpu")
        out[dtype] = (jidx, tidx)
    return out


def test_state_round_trip(carried):
    jidx, tidx = carried["bfloat16"]
    js, ts = jidx.state_dict(), tidx.state_dict()
    assert set(js) == set(ts)
    for key in js:
        if isinstance(js[key], np.ndarray):
            assert type(ts[key]) is np.ndarray and ts[key].dtype == js[key].dtype, key
            np.testing.assert_array_equal(ts[key], js[key])
        else:
            assert ts[key] == js[key] and type(ts[key]) is type(js[key]), key
    # and back: the JAX index attaches the port's state
    back = jivf.IVFIndex.from_state(ts, carried["mat"])
    np.testing.assert_array_equal(np.asarray(back._list_ids), np.asarray(jidx._list_ids))
    again = tivf.IVFIndex.from_state(ts, torch.from_numpy(carried["mat"]))
    assert again._lists.dtype == torch.bfloat16 and again._data is not None
    assert torch.equal(again._lists, tidx._lists)
    with pytest.raises(ValueError, match="corpus has"):
        tivf.IVFIndex.from_state(ts, carried["mat"][:100], device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        convert.ivf_state_from_numpy({"nlist": 3})
    bad = dict(ts, pad_len=ts["pad_len"] + 128)
    with pytest.raises(ValueError, match="pad_len"):
        convert.ivf_state_from_numpy(bad)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_deletes_and_tombstones_match_on_the_same_tables(carried, dtype):
    rng = np.random.default_rng(11)
    jidx, _ = carried[dtype]
    state = jidx.state_dict()
    mat = carried["mat"]
    j = jivf.IVFIndex.from_state(state, mat)
    t = tivf.IVFIndex.from_state(convert.ivf_state_from_numpy(state), mat, device="cpu")
    rows = rng.choice(N + 50, 120, replace=False).tolist()  # some past count
    before = t.snapshot()
    assert t.tombstone_rows(rows) == j.tombstone_rows(rows)
    np.testing.assert_array_equal(t._list_valid.numpy(), np.asarray(j._list_valid))
    assert t.count == j.count == N
    # the tables were swapped, not written: an older snapshot keeps its view
    assert int(before.tables[2].sum()) == N
    assert t.tombstone_rows(rows) == j.tombstone_rows(rows) == 0
    assert t.delete_rows(rows) == j.delete_rows(rows)
    np.testing.assert_array_equal(t._list_ids.numpy(), np.asarray(j._list_ids))
    np.testing.assert_array_equal(t._list_valid.numpy(), np.asarray(j._list_valid))
    assert t.count == j.count
    assert t.delete_rows([N + 7]) == j.delete_rows([N + 7]) == 0

    # the same on persisted, not yet attached, states
    js, ts = dict(state), convert.ivf_state_from_numpy(state)
    assert (tivf.IVFIndex.state_tombstone_rows(ts, rows[:40])
            == jivf.IVFIndex.state_tombstone_rows(js, rows[:40]))
    np.testing.assert_array_equal(ts["list_valid"], js["list_valid"])
    assert ts["count"] == js["count"]
    assert (tivf.IVFIndex.state_after_deletes(ts, rows)
            == jivf.IVFIndex.state_after_deletes(js, rows))
    np.testing.assert_array_equal(ts["list_ids"], js["list_ids"])
    np.testing.assert_array_equal(ts["list_valid"], js["list_valid"])
    assert ts["count"] == js["count"]
    assert tivf.IVFIndex.state_tombstone_rows(ts, []) == 0


def _assert_same_results(tv, ti, jv, ji, atol=2e-5):
    tv, ti, jv, ji = (np.asarray(x) for x in (tv, ti, jv, ji))
    assert tv.shape == jv.shape and ti.shape == ji.shape
    np.testing.assert_allclose(tv, jv, rtol=0, atol=atol)
    differ = (ti != ji) & (jv > -1e38)  # sentinel slots carry arbitrary ids
    if differ.any():
        gap = np.minimum(
            np.abs(np.diff(jv, axis=1, prepend=np.inf)),
            np.abs(np.diff(jv, axis=1, append=-np.inf)),
        )
        assert (gap[differ] <= 2 * atol).all(), (ti[differ], ji[differ])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("batch", [4, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_snapshot_search_matches_the_jax_snapshot(carried, monkeypatch, dtype,
                                                  batch, masked):
    """f32; bf16 + rescore; int8 + rescore. Batch 4 takes the paged probe
    (int8: the grouped one), batch 32 the grouped probe."""
    monkeypatch.setattr(jivf, "_FORCE_PALLAS_ROUTE", True)
    jidx, tidx = carried[dtype]
    rng = np.random.default_rng(20 + batch)
    q = rng.standard_normal((batch, 128)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if masked:
        mask = (np.arange(N) % 4) != 3
        kw_j = {"mask_dev": jnp.asarray(mask), "mask_frac": 0.75}
        kw_t = {"mask_dev": torch.from_numpy(mask), "mask_frac": 0.75}
    jv, ji = jidx.snapshot().search(q, 10, **kw_j)
    tv, ti = tidx.snapshot().search(q, 10, **kw_t)
    assert isinstance(tv, np.ndarray) and ti.dtype == np.int32
    # quantized lists rescore exactly against the float32 corpus, so the
    # final scores are float32 cosines in every dtype. The port's packed
    # values can differ from JAX's by one quantization step on a handful of
    # slots (from_state re-normalizes), which may swap a candidate at the
    # very edge of the wide stage: compare ids where scores agree.
    _assert_same_results(tv, ti, jv, ji)
    if masked:
        assert mask[ti[tv > -1e38]].all()
    # a tensor batch, and deferred fetch, give the same answer
    dv, di = tidx.snapshot().search(torch.from_numpy(q), 10, fetch=False, **kw_t)
    assert isinstance(dv, torch.Tensor)
    np.testing.assert_array_equal(di.numpy(), ti)
    np.testing.assert_array_equal(dv.numpy(), tv)


def test_snapshot_search_when_nothing_is_left_alive(carried):
    jidx, _ = carried["float32"]
    state = convert.ivf_state_from_numpy(jidx.state_dict())
    t = tivf.IVFIndex.from_state(state, carried["mat"], device="cpu")
    t.delete_rows(list(range(N)))
    assert t.count == 0
    vals, ids = t.snapshot().search(carried["mat"][:3], 5)
    assert vals.shape == (3, 0) and ids.shape == (3, 0)
    assert vals.dtype == np.float32 and ids.dtype == np.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_nprobe_nlist_equals_the_exact_scan(carried, dtype):
    _, tidx = carried[dtype]
    mat = carried["mat"]
    rng = np.random.default_rng(30)
    q = rng.standard_normal((32, 128)).astype(np.float32)
    nlist = int(tidx.centroids.shape[0])
    vals, ids = tidx.search(q, 10, nprobe=nlist)
    s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        mat / np.linalg.norm(mat, axis=1, keepdims=True)).T
    want = np.argsort(-s, axis=1)[:, :10]
    if dtype == "float32":
        np.testing.assert_array_equal(ids, want)
    else:  # the quantized candidate stage may miss a neighbour at the edge
        hit = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, want)])
        assert hit >= 0.99, hit
    got_scores = np.take_along_axis(s, ids.astype(np.int64), 1)
    np.testing.assert_allclose(vals, got_scores, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kernel_routes_equal_the_plain_formulation(carried, dtype):
    """ivf_search_grouped / ivf_search_paged against _ivf_search, the probe
    written one query and one list at a time, on the same snapshot."""
    from minivectordb_tpu_torch.ops import ivf_probe

    _, tidx = carried[dtype]
    snap = tidx.snapshot()
    lists, list_ids, list_valid = snap.tables
    rng = np.random.default_rng(40)
    for batch in (3, 20):
        q = torch.from_numpy(rng.standard_normal((batch, 128)).astype(np.float32))
        xv, xi = tivf._ivf_search(snap.centroids, lists, list_ids, list_valid,
                                  q, 5, 12, list_inv=snap.list_inv)
        if batch >= 16 or dtype == "int8":
            kv, ki = ivf_probe.ivf_search_grouped(
                snap.centroids, lists, list_ids, list_valid, q, 5, 12,
                list_inv=snap.list_inv)
        else:
            kv, ki = ivf_probe.ivf_search_paged(
                snap.centroids, lists, list_ids, list_valid, q, 5, 12)
        _assert_same_results(kv, ki, xv, xi, atol=0 if dtype == "int8" else 2e-5)


def test_helpers_match():
    for kk, frac, count in [(10, 0.75, 3000), (10, 0.5, 3000), (5, 1e-9, 40),
                            (10, 2.0, 3000), (7, 0.3, 9)]:
        assert (tivf.masked_overfetch_width(kk, frac, count)
                == jivf.masked_overfetch_width(kk, frac, count))
    for k in (1, 10, 40):
        assert tivf._rescore_kwide(k, torch.int8) == jivf._rescore_kwide(k, jnp.int8)
        assert tivf._rescore_kwide(k, torch.bfloat16) == jivf._rescore_kwide(k, jnp.bfloat16)
    rng = np.random.default_rng(50)
    vals = rng.standard_normal((4, 12)).astype(np.float32)
    vals[:, 3] = -3.0e38
    ids = rng.integers(0, 100, size=(4, 12)).astype(np.int32)
    mask = rng.random(100) < 0.6
    jm = jivf._mask_scores(jnp.asarray(mask), jnp.asarray(vals), jnp.asarray(ids))
    tm = tivf._mask_scores(torch.from_numpy(mask), torch.from_numpy(vals), torch.from_numpy(ids))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jv, ji = jivf._select_topk(jm, jnp.asarray(ids), 5)
    tv, ti = tivf._select_topk(tm, torch.from_numpy(ids), 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    data = rng.standard_normal((100, 16)).astype(np.float32)
    inv = (1.0 / np.linalg.norm(data, axis=1)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    jv, ji = jivf._exact_rescore(jnp.asarray(data), jnp.asarray(inv), jnp.asarray(q),
                                 jm, jnp.asarray(ids), 5)
    tv, ti = tivf._exact_rescore(torch.from_numpy(data), torch.from_numpy(inv),
                                 torch.from_numpy(q), tm, torch.from_numpy(ids), 5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
