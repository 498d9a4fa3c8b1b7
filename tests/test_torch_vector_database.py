"""The slice as a whole: the same script of operations runs on
minivectordb_tpu.VectorDatabase and on
minivectordb_tpu_torch.VectorDatabase(device="cpu"), for each device_dtype, at
a corpus of 6000 x 32 with batch 32, so the fused route is taken on both sides
(the JAX side through MINIVECTORDB_TPU_FORCE_PALLAS, kernels interpreted).
Ids and metadata must be equal, scores within 1e-5 (another summation order
in float32; int8 dots are exact)."""

import pickle
from collections import defaultdict

import numpy as np
import pytest

from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import VectorDatabase as TorchDB
from minivectordb_tpu_torch import convert

DTYPES = ["float32", "bfloat16", "mixed", "int8"]
N, D, B, K = 6000, 32, 32, 10


def _data(seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    metas = [{"bucket": i % 16, "parity": "even" if i % 2 == 0 else "odd",
              "rank": float(i)} for i in range(N)]
    return rng, corpus, queries, metas


def _same_hits(got, want, atol=1e-5):
    g_ids, g_scores, g_md = got
    w_ids, w_scores, w_md = want
    assert list(g_ids) == list(w_ids)
    assert list(g_md) == list(w_md)
    np.testing.assert_allclose(
        np.asarray(g_scores, np.float64), np.asarray(w_scores, np.float64),
        rtol=0, atol=atol,
    )


def _same_batch(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_hits(g, w)


def _script(db, corpus, queries, metas):
    """One script of operations; returns everything observable."""
    out = {}
    db.store_embeddings_batch(list(range(N - 50)), corpus[: N - 50], metas[: N - 50])
    for i in range(N - 50, N):
        db.store_embedding(i, corpus[i], metas[i])
    with pytest.raises(ValueError):
        db.store_embedding(7, corpus[7], {})
    with pytest.raises(ValueError):
        db.store_embeddings_batch([N + 1, 3], corpus[:2], [{}, {}])
    out["batch"] = db.find_most_similar_batch(queries, k=K)
    out["single"] = [db.find_most_similar(q, k=K) for q in queries[:3]]
    out["filtered"] = db.find_most_similar_batch(
        queries, k=K, metadata_filter={"bucket": 3})
    out["excluded"] = db.find_most_similar_batch(
        queries, k=K, exclude_filter={"parity": "odd"})
    out["or"] = db.find_most_similar_batch(
        queries, k=K, metadata_filter={"rank": {"$gte": 1000.0}},
        or_filters=[{"bucket": 1}, {"bucket": 2}])
    out["narrow"] = db.find_most_similar_batch(
        queries, k=K, metadata_filter={"rank": {"$lt": 4.0}})  # < k candidates
    per_query = [{"bucket": i % 3} if i % 4 else None for i in range(B)]
    out["per_query"] = db.find_most_similar_batch(
        queries, k=K, metadata_filters=per_query)
    handles = [db.find_most_similar_batch_async(queries[i:i + 16], k=K,
                                                metadata_filter={"parity": "even"})
               for i in (0, 16)]
    out["async"] = handles[0].result() + handles[1].result()
    doomed = sorted({int(h[0][0]) for h in out["batch"]} | {5, 6, 4000})
    for uid in doomed:
        db.delete_embedding(uid)
    with pytest.raises(ValueError):
        db.delete_embedding(doomed[0])
    out["doomed"] = doomed
    out["after_delete"] = db.find_most_similar_batch(queries, k=K)
    out["after_delete_single"] = db.find_most_similar(queries[0], k=K)
    out["after_delete_filtered"] = db.find_most_similar_batch(
        queries, k=K, metadata_filter={"bucket": 3})
    out["autocut"] = db.find_most_similar(corpus[100], k=K, autocut=True)
    out["len"] = len(db.id_map)
    out["id_of_row_5"] = db.id_map[5]
    out["vector"] = np.array(db.get_vector(77))
    db.persist_to_disk()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages run the script once per device_dtype."""
    import os

    os.environ["MINIVECTORDB_TPU_FORCE_PALLAS"] = "1"
    try:
        _, corpus, queries, metas = _data()
        out = {}
        for dtype in DTYPES:
            tmp = tmp_path_factory.mktemp(dtype)
            jpath, tpath = str(tmp / "jax.pkl"), str(tmp / "torch.pkl")
            jdb = JaxDB(storage_file=jpath, device_dtype=dtype)
            tdb = TorchDB(storage_file=tpath, device_dtype=dtype, device="cpu")
            out[dtype] = {
                "jax": _script(jdb, corpus, queries, metas),
                "torch": _script(tdb, corpus, queries, metas),
                "jpath": jpath, "tpath": tpath, "tdb": tdb,
            }
        yield out
    finally:
        del os.environ["MINIVECTORDB_TPU_FORCE_PALLAS"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "step",
    ["batch", "filtered", "excluded", "or", "narrow", "per_query", "async",
     "after_delete", "after_delete_filtered"],
)
def test_batched_searches_match(runs, dtype, step):
    _same_batch(runs[dtype]["torch"][step], runs[dtype]["jax"][step])


@pytest.mark.parametrize("dtype", DTYPES)
def test_single_searches_autocut_and_state_match(runs, dtype):
    j, t = runs[dtype]["jax"], runs[dtype]["torch"]
    _same_batch(t["single"], j["single"])
    _same_hits(t["after_delete_single"], j["after_delete_single"])
    _same_hits(t["autocut"], j["autocut"])
    assert t["doomed"] == j["doomed"]
    assert t["len"] == j["len"] == N - len(t["doomed"])
    assert t["id_of_row_5"] == j["id_of_row_5"]
    np.testing.assert_array_equal(t["vector"], j["vector"])
    gone = set(t["doomed"])
    assert not any(i in gone for hits in t["after_delete"] for i in hits[0])
    assert all(md["bucket"] == 3 for hits in t["filtered"] for md in hits[2])
    assert all(len(hits[0]) == 4 for hits in t["narrow"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_fused_route_served_the_batches(runs, dtype):
    stats = runs[dtype]["tdb"].stats()
    assert stats["routing"]["device"] == "cpu"
    assert stats["device_dtype"] == dtype
    assert stats["tombstoned_rows"] == 0  # persist_to_disk compacted them
    assert stats["ops"]["device_scan"]["count"] > 0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pickles_cross_load(runs, dtype):
    """db.pkl holds numpy and builtins only; each package loads the other's."""
    _, corpus, queries, _ = _data()
    r = runs[dtype]
    for path in (r["jpath"], r["tpath"]):
        with open(path, "rb") as f:
            raw = f.read()
        assert b"minivectordb" not in raw and b"torch" not in raw and b"jax" not in raw
        data = pickle.loads(raw)
        assert set(data) == {"embeddings", "metadata", "id_map",
                             "inverse_id_map", "inverted_index"}
        assert type(data["embeddings"]) is np.ndarray
        assert isinstance(data["inverted_index"], (dict, defaultdict))
    with open(r["jpath"], "rb") as f:
        jdata = pickle.load(f)
    with open(r["tpath"], "rb") as f:
        tdata = pickle.load(f)
    np.testing.assert_array_equal(tdata["embeddings"], jdata["embeddings"])
    assert tdata["id_map"] == jdata["id_map"]
    assert tdata["metadata"] == jdata["metadata"]
    assert tdata["inverse_id_map"] == jdata["inverse_id_map"]
    assert dict(tdata["inverted_index"]) == dict(jdata["inverted_index"])

    t_from_j = TorchDB(storage_file=r["jpath"], device_dtype=dtype, device="cpu")
    j_from_t = JaxDB(storage_file=r["tpath"], device_dtype=dtype)
    assert len(t_from_j.id_map) == len(j_from_t.id_map) == r["torch"]["len"]
    _same_batch(t_from_j.find_most_similar_batch(queries[:8], k=K),
                j_from_t.find_most_similar_batch(queries[:8], k=K))
    _same_batch(
        t_from_j.find_most_similar_batch(queries, k=K, metadata_filter={"bucket": 3}),
        r["torch"]["after_delete_filtered"],
    )


def test_store_state_from_numpy_round_trip(runs):
    _, corpus, queries, metas = _data()
    with open(runs["float32"]["jpath"], "rb") as f:
        data = pickle.load(f)
    uids = [data["id_map"][i] for i in sorted(data["id_map"])]
    eng = convert.store_state_from_numpy(
        data["embeddings"], uids, data["metadata"], data["inverted_index"],
        device="cpu",
    )
    assert eng.count == len(uids)
    np.testing.assert_array_equal(eng.embeddings_view, data["embeddings"])
    _same_batch(eng.search_batch(queries, k=K), runs["float32"]["torch"]["after_delete"])
    _same_batch(
        eng.search_batch(queries, k=K, metadata_filter={"bucket": 3}),
        runs["float32"]["torch"]["after_delete_filtered"],
    )
    rebuilt = convert.store_state_from_numpy(
        data["embeddings"], uids, data["metadata"], None, device="cpu")
    assert dict(rebuilt.inverted_index) == dict(eng.inverted_index)


def test_store_state_from_numpy_carries_device_arrays():
    """A JAX store's device arrays cross as numpy (bf16 as uint16 views) and
    become tensors with the same bytes."""
    import jax.numpy as jnp
    import torch

    from minivectordb_tpu.core.store import VectorStore as JStore

    rng = np.random.default_rng(3)
    js = JStore(16, "mixed")
    js.append(rng.standard_normal((300, 16)).astype(np.float32))
    jb, ji, _ = js.sync()
    shadow = np.asarray(js._scan_buf).view(np.uint16)
    buf, inv, scan = convert.store_state_from_numpy(
        buf=np.asarray(jb), inv_norms=np.asarray(ji), scan_buf=shadow, device="cpu")
    assert buf.dtype == torch.float32 and scan.dtype == torch.bfloat16
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        scan.to(torch.float32).numpy(),
        np.asarray(js._scan_buf.astype(jnp.float32)),
    )
    as_bf16, _, _ = convert.store_state_from_numpy(buf=shadow, device="cpu")
    assert as_bf16.dtype == torch.bfloat16 and torch.equal(as_bf16, scan)


@pytest.mark.parametrize(
    "what", ["ivf", "mesh", "calibrate_nprobe", "hybrid_device", "approx"])
def test_unported_parts_raise_and_approx_serves(tmp_path, what):
    path = str(tmp_path / "x.pkl")
    if what == "ivf":
        db = TorchDB(storage_file=path, index="ivf", device="cpu")
        assert db.stats()["ivf"]["built"] is False
        with pytest.raises(ValueError):
            TorchDB(storage_file=path, index="hnsw", device="cpu")
    elif what == "mesh":
        # mesh= is ported (parallel/): what is not a Mesh, or a device that
        # disagrees with the mesh, raises
        import torch

        from minivectordb_tpu_torch.parallel.mesh import search_mesh

        with pytest.raises(TypeError, match="Mesh"):
            TorchDB(storage_file=path, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="disagrees"):
            TorchDB(storage_file=path, mesh=search_mesh(2, device="cpu"), device="meta")
        db = TorchDB(storage_file=path, mesh=search_mesh(2, device="cpu"))
        assert db._engine.device == torch.device("cpu")
    elif what == "calibrate_nprobe":
        with pytest.raises(ValueError, match="calibrate_nprobe requires index='ivf'"):
            TorchDB(storage_file=path, device="cpu").calibrate_nprobe()
    elif what == "hybrid_device":
        # device=True runs the device rerank on the database's own device
        db = TorchDB(storage_file=path, device="cpu")
        from minivectordb_tpu.rerank.hybrid import hybrid_rerank_results as jhybrid

        got = db.hybrid_rerank_results(["ab", "cd"], [0.1, 0.9], "cd", k=1, device=True)
        want = jhybrid(["ab", "cd"], [0.1, 0.9], "cd", k=1, device=True)
        assert got[0] == want[0] == ("cd",) and abs(got[1][0] - want[1][0]) <= 1e-4
        assert db.hybrid_rerank_results(["ab", "cd"], [0.1, 0.9], "cd", k=1)[0] == ("cd",)
    else:
        _, corpus, queries, _ = _data()
        db = TorchDB(storage_file=path, search_mode="approx", device="cpu")
        exact = TorchDB(storage_file=path + "e", device="cpu")
        for d in (db, exact):
            d.store_embeddings_batch(list(range(N)), corpus)
        # batch 32: fused route with margin 0; batch 2: served exactly
        for q in (queries, queries[:2]):
            got = db.find_most_similar_batch(q, k=K)
            want = exact.find_most_similar_batch(q, k=K)
            assert [g[0] for g in got] == [w[0] for w in want]


def test_tensor_queries_and_misc_public_api(tmp_path):
    import torch

    _, corpus, queries, metas = _data()
    db = TorchDB(storage_file=str(tmp_path / "t.pkl"), device="cpu",
                 coalesce_window_ms=0.0)
    assert db.find_most_similar(queries[0]) == ([], [], [])
    assert db.find_most_similar_batch(queries[:2]) == [([], [], [])] * 2
    assert db.embeddings is None and db.embedding_size is None
    db.store_embeddings_batch(list(range(N)), corpus, metas)
    db.warmup(k=5, batch=32)
    want = db.find_most_similar_batch(queries, k=5)
    _same_batch(db.find_most_similar_batch(torch.from_numpy(queries), k=5), want)
    _same_batch(db.find_most_similar_batch_async(torch.from_numpy(queries), k=5).result(), want)
    assert db.embedding_size == D and db.embeddings.shape == (N, D)
    assert db.nprobe == 32
    db.nprobe = 8
    assert db.nprobe == 8
    with pytest.raises(ValueError):
        db.find_most_similar(queries[0], nprobe=0)
    with pytest.raises(ValueError):
        db.find_most_similar_batch(queries, metadata_filter={"bucket": 1},
                                   metadata_filters=[None] * B)
    with pytest.raises(ValueError):
        db.find_most_similar(queries[0], metadata_filter={"bucket": {"$bogus": 1}})
    with pytest.raises(ValueError):
        db.get_vector("missing")
    with pytest.raises(ValueError):
        TorchDB(storage_file=str(tmp_path / "u.pkl"), device="cpu",
                ivf_opts={"nlists": 4})
    db.set_coalesce_window(1.0)
    _same_hits(db.find_most_similar(queries[0], k=5), want[0])
    assert db.stats()["coalescing"]["calls"] == 1
    db.set_coalesce_window(0)
    assert db.lock is db._engine.lock
    assert db.inverse_id_map[17] == 17 and 17 in db.inverted_index["bucket"]
