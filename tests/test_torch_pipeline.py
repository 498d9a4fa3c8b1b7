"""The port's TextSearchPipeline against the JAX package's, on the CPU: the
same texts are embedded by each package's own model (equal within 2e-5, see
test_torch_embedding_model.py), stored, and searched through each pipeline.
Ids must be equal, scores within 2e-5."""

import numpy as np
import pytest
import torch

from minivectordb_tpu import embedding_model as jem
from minivectordb_tpu.core import pipeline as jpl
from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import EmbeddingModel, VectorDatabase
from minivectordb_tpu_torch.core import pipeline as tpl
from minivectordb_tpu_torch.core import store as tstore

TOL = 2e-5
SENTS = ["i like animals", "i like cars", "the sky is blue", "dogs are friendly",
         "engines are loud", "cats are independent", "the stock market fell",
         "birds sing in the morning", "fish swim in the river", "the house is red"]
QUERIES = ["i like dogs", "loud cars", "blue river", "morning birds sing"]


@pytest.fixture(scope="module")
def models():
    return EmbeddingModel(device="cpu"), jem.EmbeddingModel()


def _dbs(tmp_path, models, sents=SENTS, **kw):
    tm, jm = models
    tdb = VectorDatabase(storage_file=str(tmp_path / "t.pkl"), device="cpu", **kw)
    jdb = JaxDB(storage_file=str(tmp_path / "j.pkl"), **kw)
    tdb.store_embeddings_batch(list(range(1, len(sents) + 1)), tm.extract_embeddings_batch(sents),
                               [{"i": i, "grp": "a" if i % 2 else "b"}
                                for i in range(1, len(sents) + 1)])
    jdb.store_embeddings_batch(list(range(1, len(sents) + 1)), jm.extract_embeddings_batch(sents),
                               [{"i": i, "grp": "a" if i % 2 else "b"}
                                for i in range(1, len(sents) + 1)])
    return tdb, jdb


def _same(got, want):
    assert list(got[0]) == list(want[0])
    assert np.abs(np.asarray(got[1], np.float32) - np.asarray(want[1], np.float32)).max() <= TOL \
        if len(got[0]) else True
    assert list(got[2]) == list(want[2])


@pytest.fixture
def fused_only(monkeypatch):
    """Close the tiny-corpus host shortcut on both sides, so the embed ->
    scan program serves even these small corpora."""
    import minivectordb_tpu.core.store as jstore

    monkeypatch.setattr(tstore, "_HOST_ALWAYS_BYTES", 0)
    monkeypatch.setattr(tpl, "_HOST_ALWAYS_BYTES", 0)
    monkeypatch.setattr(jstore, "_HOST_ALWAYS_BYTES", 0)
    monkeypatch.setattr(tstore, "_HOST_SCAN_MAX_BYTES", 0)
    monkeypatch.setattr(jstore, "_HOST_SCAN_MAX_BYTES", 0)


def _spy(monkeypatch):
    calls = {"n": 0}
    orig = tpl.embed_search_program

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tpl, "embed_search_program", spy)
    return calls


@pytest.mark.parametrize("device_dtype", ["float32", "mixed", "bfloat16"])
def test_fused_program_equals_the_jax_pipeline(tmp_path, models, fused_only, monkeypatch,
                                               device_dtype):
    tdb, jdb = _dbs(tmp_path, models, device_dtype=device_dtype)
    calls = _spy(monkeypatch)
    tp, jp = tpl.TextSearchPipeline(models[0], tdb), jpl.TextSearchPipeline(models[1], jdb)
    tol = TOL if device_dtype != "bfloat16" else 5e-3  # bf16 rows: one rounding of each vector
    for q in QUERIES:
        got, want = tp.search(q, k=3), jp.search(q, k=3)
        assert list(got[0]) == list(want[0]) and len(got[0]) == 3
        assert np.abs(np.asarray(got[1]) - np.asarray(want[1])).max() <= tol
    assert calls["n"] == len(QUERIES)
    got, want = tp.search(QUERIES, k=4), jp.search(QUERIES, k=4)
    assert [list(g[0]) for g in got] == [list(w[0]) for w in want]


def test_fused_program_equals_embed_then_search(tmp_path, models, fused_only, monkeypatch):
    tdb, _jdb = _dbs(tmp_path, models)
    calls = _spy(monkeypatch)
    pipe = tpl.TextSearchPipeline(models[0], tdb)
    for q in QUERIES:
        _same(pipe.search(q, k=3), tdb.find_most_similar(models[0].extract_embeddings(q), k=3))
    batch = pipe.search(QUERIES, k=5)
    two = tdb.find_most_similar_batch(models[0].extract_embeddings_batch(QUERIES), k=5)
    for got, want in zip(batch, two):
        _same(got, want)
    assert calls["n"] == len(QUERIES) + 1
    # int8 rows go through the exact integer route of ops/scan.py
    idb = VectorDatabase(storage_file=str(tmp_path / "i8.pkl"), device="cpu", device_dtype="int8")
    idb.store_embeddings_batch(list(range(1, 11)), models[0].extract_embeddings_batch(SENTS),
                               [{} for _ in SENTS])
    ipipe = tpl.TextSearchPipeline(models[0], idb)
    got = ipipe.search("i like animals", k=2)
    want = idb.find_most_similar(models[0].extract_embeddings("i like animals"), k=2)
    assert list(got[0]) == list(want[0]) and got[0][0] == 1
    assert np.abs(np.asarray(got[1]) - np.asarray(want[1])).max() <= TOL


def test_filters_and_batches(tmp_path, models, fused_only):
    tdb, jdb = _dbs(tmp_path, models)
    tp, jp = tpl.TextSearchPipeline(models[0], tdb), jpl.TextSearchPipeline(models[1], jdb)
    for kw in ({"metadata_filter": {"i": {"$lte": 2}}}, {"metadata_filter": {"grp": "a"}},
               {"exclude_filter": [{"grp": "b"}]}, {"or_filters": [{"i": 1}, {"i": 7}]},
               {"metadata_filter": {"i": {"$gt": 100}}}):
        got, want = tp.search("beta animals", k=10, **kw), jp.search("beta animals", k=10, **kw)
        _same(got, want)
        multi = tp.search(QUERIES, k=10, **kw)
        for g, w in zip(multi, jp.search(QUERIES, k=10, **kw)):
            _same(g, w)
    ids, _, metas = tp.search("beta", k=10, metadata_filter={"i": {"$lte": 2}})
    assert set(ids) == {1, 2} and {m["i"] for m in metas} == {1, 2}
    assert tp.search("x", k=3, metadata_filter={"i": {"$gt": 100}}) == ([], [], [])


def test_empty_database_and_deleted_rows(tmp_path, models, fused_only):
    tm = models[0]
    db = VectorDatabase(storage_file=str(tmp_path / "e.pkl"), device="cpu")
    pipe = tpl.TextSearchPipeline(tm, db)
    assert pipe.search("anything", k=3) == ([], [], [])
    assert pipe.search(["a", "b"], k=3) == [([], [], []), ([], [], [])]
    db.store_embeddings_batch(list(range(1, 11)), tm.extract_embeddings_batch(SENTS),
                              [{} for _ in SENTS])
    assert pipe.search(SENTS[3], k=1)[0] == (4,)
    db.delete_embedding(4)  # a tombstone: the row must not be found any more
    ids, _scores, _m = pipe.search(SENTS[3], k=10)
    assert 4 not in ids and len(ids) == 9
    _same(pipe.search(SENTS[3], k=10), db.find_most_similar(tm.extract_embeddings(SENTS[3]), k=10))


def test_tiny_corpus_shortcut_skips_the_fused_program(tmp_path, models, monkeypatch):
    tdb, jdb = _dbs(tmp_path, models)
    calls = _spy(monkeypatch)
    tp, jp = tpl.TextSearchPipeline(models[0], tdb), jpl.TextSearchPipeline(models[1], jdb)
    got = tp.search("i like dogs", k=2)
    assert calls["n"] == 0  # tiny corpus: host two-step, no fused program
    _same(got, jp.search("i like dogs", k=2))
    _same(got, tdb.find_most_similar(models[0].extract_embeddings("i like dogs"), k=2))
    got = tp.search("dogs", k=4, metadata_filter={"grp": "a"})
    assert {m["grp"] for m in got[2]} == {"a"} and len(got[0]) == 4
    _same(got, jp.search("dogs", k=4, metadata_filter={"grp": "a"}))
    assert calls["n"] == 0
    # batches over the host route's bound take the program
    tp.search(["q %d" % i for i in range(tstore._HOST_SCAN_MAX_BATCH + 1)], k=2)
    assert calls["n"] == 1


def test_ivf_database_goes_through_the_probe(tmp_path, models):
    opts = {"build_threshold": 4, "nlist": 4, "nprobe": 64, "iters": 3}
    tdb, jdb = _dbs(tmp_path, models, index="ivf", ivf_opts=opts)
    tp, jp = tpl.TextSearchPipeline(models[0], tdb), jpl.TextSearchPipeline(models[1], jdb)
    got, want = tp.search("i like dogs", k=3), jp.search("i like dogs", k=3)
    assert tdb.stats()["ops"]["ivf_scan"]["count"] >= 1
    # every list is probed (nprobe >= nlist), so both packages are exact
    _same(got, want)
    for g, w in zip(tp.search(QUERIES, k=3, metadata_filter={"grp": "a"}),
                    jp.search(QUERIES, k=3, metadata_filter={"grp": "a"})):
        _same(g, w)
    _same(got, tdb.find_most_similar(models[0].extract_embeddings("i like dogs"), k=3))


def test_model_and_database_must_share_a_device(tmp_path, models):
    class Elsewhere:
        device = torch.device("cuda", 0)

    db = VectorDatabase(storage_file=str(tmp_path / "d.pkl"), device="cpu")
    with pytest.raises(ValueError, match="one device"):
        tpl.TextSearchPipeline(Elsewhere(), db)


def test_embed_search_program_returns_unit_queries_and_masks_rows(models):
    tm = models[0]
    enc = tm.model
    vecs = torch.from_numpy(tm.extract_embeddings_batch(SENTS))
    buf = torch.zeros((16, vecs.shape[1]))
    buf[:10] = vecs * 3.0  # raw rows: the scan divides by their norms
    inv = torch.zeros(16)
    inv[:10] = 1.0 / 3.0
    ids, mask = enc._tokenize_padded([SENTS[2], SENTS[5]], 512)
    row_mask = torch.ones(16, dtype=torch.bool)
    row_mask[2] = False
    q, vals, idx = tpl.embed_search_program(
        enc.encoder, torch.from_numpy(ids), torch.from_numpy(mask), buf, inv, 10, 4,
        enc.pooling, row_mask)
    assert q.shape == (2, vecs.shape[1]) and idx.dtype == torch.int32
    assert np.allclose(q.norm(dim=1).numpy(), 1.0, atol=1e-5)
    assert idx[1, 0] == 5 and abs(float(vals[1, 0]) - 1.0) <= TOL
    assert 2 not in idx[0].tolist() and (idx < 10).all()
