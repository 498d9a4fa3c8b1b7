"""The port's host-only modules (filters, hashing, fuzzy, hybrid rerank,
autocut, telemetry) against the JAX package's on shared inputs. They are
copies, so every comparison is exact. The random metadata and filters come
from the generators of tests/test_filter_fuzz.py."""

import random

import numpy as np
import pytest

from test_filter_fuzz import KEYS, _rand_filter_dict, _rand_meta

from minivectordb_tpu.core import engine as jengine
from minivectordb_tpu.filters import engine as jfilters
from minivectordb_tpu.rerank import fuzzy as jfuzzy
from minivectordb_tpu.rerank import hashing as jhashing
from minivectordb_tpu.rerank.hybrid import hybrid_rerank_results as jhybrid
from minivectordb_tpu.utils.telemetry import Telemetry as JTelemetry
from minivectordb_tpu_torch.core import engine as tengine
from minivectordb_tpu_torch.filters import engine as tfilters
from minivectordb_tpu_torch.rerank import fuzzy as tfuzzy
from minivectordb_tpu_torch.rerank import hashing as thashing
from minivectordb_tpu_torch.rerank.hybrid import hybrid_rerank_results as thybrid
from minivectordb_tpu_torch.utils.telemetry import Telemetry as TTelemetry

WORDS = ["vector", "database", "tensor", "kernel", "café", "naïve", "search",
         "index", "query", "über", "scan", "a", "", "The quick brown fox"]


def _sentences(seed, n):
    rng = random.Random(seed)
    return [
        " ".join(rng.choice(WORDS) for _ in range(rng.randint(0, 7)))
        for _ in range(n)
    ]


def _context(mod, metas):
    index = mod.MetadataIndex()
    columns = mod.ColumnStore()
    uids = [f"u{i}" for i in range(len(metas))]
    for uid, md in zip(uids, metas):
        index.add(uid, md)
    columns.append_many(metas)
    inverse = {uid: i for i, uid in enumerate(uids)}
    return mod.FilterContext(index, inverse, metas, columns)


@pytest.mark.parametrize("seed", [5, 19, 41])
def test_filters_select_the_same_rows(seed):
    rng = random.Random(seed)
    n = 250
    metas = [_rand_meta(rng) for _ in range(n)]
    pool = [v for m in metas for v in m.values() if v is not None][:40]
    jctx, tctx = _context(jfilters, metas), _context(tfilters, metas)
    for _ in range(100):
        md = _rand_filter_dict(rng, pool) if rng.random() < 0.8 else None
        orf = (
            [_rand_filter_dict(rng, pool) for _ in range(rng.choice([1, 2]))]
            if rng.random() < 0.4 else None
        )
        exc = {rng.choice(KEYS): rng.choice(pool)} if rng.random() < 0.4 else None
        jsel = jfilters.select_rows(jctx, md, exc, orf)
        tsel = tfilters.select_rows(tctx, md, exc, orf)
        assert tsel.n_candidates(n) == jsel.n_candidates(n)
        jm, tm = jsel.to_mask(n), tsel.to_mask(n)
        assert (jm is None) == (tm is None)
        if jm is not None:
            np.testing.assert_array_equal(tm, jm)
        assert tfilters.filters_cache_key(md, exc, orf) == jfilters.filters_cache_key(md, exc, orf)


def test_filter_errors_match():
    metas = [{"a": 1}, {"a": 2}]
    for mod in (jfilters, tfilters):
        with pytest.raises(ValueError):
            mod.select_rows(_context(mod, metas), {"a": {"$bogus": 1}}, None, None)


def test_metadata_index_remove_and_rebuild_match():
    rng = random.Random(3)
    metas = [_rand_meta(rng) for _ in range(60)]
    uids = list(range(60))
    out = []
    for mod in (jfilters, tfilters):
        index = mod.MetadataIndex()
        index.rebuild(uids, metas)
        for uid in (3, 10, 11):
            index.remove(uid, metas[uid])
        out.append({k: set(v) for k, v in index.inverted_index.items()})
    assert out[0] == out[1]


@pytest.mark.parametrize("text", ["", "a", "hello world", "Ünïcödé çafé", "x" * 80])
def test_hashing_matches(text):
    assert thashing.murmur3_32(text.encode("utf-8")) == jhashing.murmur3_32(text.encode("utf-8"))
    want = jhashing.hash_text_features(text)
    got = thashing.hash_text_features(text)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_text_hash_scores_match():
    docs = _sentences(1, 40)
    want = jhashing.text_hash_scores("vector database search", docs)
    got = thashing.text_hash_scores("vector database search", docs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert thashing.text_hash_scores("q", []) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzzy_matches(seed):
    docs = _sentences(seed, 40) + ["y" * 70 + "vector" + "z" * 70]
    for query in ("vector database", "", "naïve café search index", "q" * 70):
        assert tfuzzy.fuzzy_ratios(query, docs) == jfuzzy.fuzzy_ratios(query, docs)
        for doc in docs[:10]:
            assert tfuzzy.ratio(query, doc) == jfuzzy.ratio(query, doc)
            assert tfuzzy._indel_distance(query, doc) == jfuzzy._indel_distance(query, doc)


@pytest.mark.parametrize("n", [0, 6, 31, 40])
def test_hybrid_rerank_host_path_matches(n):
    """The JAX package's host path (device=False) at every candidate count;
    the port's default (device=None) is that host path below 32 candidates,
    and at 32 and more routes to the device rerank as JAX's does (held to
    JAX's default there within 1e-4, the device rerank tests' tolerance)."""
    rng = np.random.default_rng(n)
    docs = _sentences(n + 7, n)
    scores = rng.random(n).tolist()
    want = jhybrid(docs, scores, "vector search kernel", k=5, device=False)
    got = thybrid(docs, scores, "vector search kernel", k=5, device=False)
    assert list(got[0]) == list(want[0])
    np.testing.assert_allclose(
        np.asarray(got[1], dtype=np.float64),
        np.asarray(want[1], dtype=np.float64), rtol=0, atol=1e-12,
    )
    default = thybrid(docs, scores, "vector search kernel", k=5, torch_device="cpu")
    if n < 32:
        assert default == got
    else:
        jdefault = jhybrid(docs, scores, "vector search kernel", k=5)
        assert list(default[0]) == list(jdefault[0]) == list(got[0])
        np.testing.assert_allclose(np.asarray(default[1], np.float64),
                                   np.asarray(jdefault[1], np.float64), rtol=0, atol=1e-4)


def test_hybrid_rerank_device_true_raises_and_degrades_like_jax():
    """device=True runs the device rerank (without a card only when asked
    for the CPU); the host path degrades like JAX's on a bad input."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            thybrid(["a", "b"], [0.5, 0.4], "a", device=True)
    got = thybrid(["a", "b"], [0.5, 0.4], "a", device=True, torch_device="cpu")
    want = jhybrid(["a", "b"], [0.5, 0.4], "a", device=True)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    # the graceful-degrade contract: a bad input returns the truncated inputs
    bad = (["a", "b", "c"], [0.3, "x", 0.1], "a")
    assert thybrid(*bad, k=2) == jhybrid(*bad, k=2, device=False)


@pytest.mark.parametrize(
    "scores",
    [[0.9, 0.85, 0.5, 0.45], [0.9, 0.89, 0.88], [0.0, 0.0, 0.0], [1.0, 0.0],
     [0.0, 0.5, 0.2], [0.5, -0.2, -0.9]],
)
def test_autocut_matches(scores):
    assert tengine.autocut_scores(scores) == jengine.autocut_scores(scores)
    dist = [1.0 - s for s in scores]
    assert tengine.autocut_distances(dist) == jengine.autocut_distances(dist)
    cut = tengine.autocut_scores(scores)
    ids, md = list(range(len(scores))), [{} for _ in scores]
    assert tengine.apply_autocut(cut, ids, scores, md) == jengine.apply_autocut(cut, ids, scores, md)


def test_format_hits_match():
    vals = np.array([[0.9, 0.5, -3.0e38], [0.8, 0.7, 0.6]], dtype=np.float32)
    idx = np.array([[2, 0, 0], [1, 2, 0]], dtype=np.int32)
    uids, md = ["a", "b", "c"], [{"i": 0}, {"i": 1}, {"i": 2}]
    for rd in (False, True):
        assert (tengine.SearchEngine._format_hits_batch(vals, idx, uids, md, rd)
                == jengine.SearchEngine._format_hits_batch(vals, idx, uids, md, rd))
        assert (tengine.SearchEngine._format_hits_batch(vals[1:], idx[1:], uids, md, rd)
                == jengine.SearchEngine._format_hits_batch(vals[1:], idx[1:], uids, md, rd))


def test_telemetry_matches():
    out = []
    for cls in (JTelemetry, TTelemetry):
        t = cls()
        with t.timed("op"):
            pass
        t.incr("n", 3)
        snap = t.snapshot()
        out.append((sorted(snap), snap["op"]["count"], snap["n"]["count"],
                    sorted(snap["op"])))
        t.reset()
        assert t.snapshot() == {}
    assert out[0] == out[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from minivectordb_tpu_torch.utils.telemetry import trace

    with trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert log_dir == str(tmp_path / "tr")


def test_trace_writes_the_program_spans_on_the_trace_time_base(tmp_path):
    import json
    import time

    from minivectordb_tpu_torch import VectorDatabase
    from minivectordb_tpu_torch.utils.telemetry import SPAN_TRACK_PID, trace

    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((64, 16)).astype(np.float32)
    db = VectorDatabase(storage_file=str(tmp_path / "db.pkl"), device="cpu")
    db.store_embeddings_batch(list(range(64)), vecs, [{"i": i} for i in range(64)])
    with trace(str(tmp_path / "tr")):
        t0 = time.time_ns()
        db.find_most_similar(vecs[0], k=3)
        t1 = time.time_ns()
    with open(tmp_path / "tr" / "trace.json", encoding="utf-8") as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    (root,) = [e for e in spans if e["name"] == "search"]
    assert root["ph"] == "X" and root["pid"] == SPAN_TRACK_PID
    assert root["args"]["parent_id"] is None
    # microseconds after the trace's base, as the profiler's own events
    assert t0 / 1e3 - 1 <= base / 1e3 + root["ts"] <= t1 / 1e3 + 1
    assert root["dur"] <= (t1 - t0) / 1e3 + 1
    kids = {e["name"] for e in spans if e["args"]["parent_id"] == root["args"]["span_id"]}
    assert {"search.filter", "search.scan", "search.format"} <= kids
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and min(e["ts"] for e in ops) < root["ts"] + root["dur"]


def test_merge_topk_device_matches():
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(12)
    va = -np.sort(-rng.random((3, 4)).astype(np.float32), axis=1)
    vb = -np.sort(-rng.random((3, 5)).astype(np.float32), axis=1)
    vb[0, 0] = va[0, 0]  # a tie across the two lists: the first list wins
    ia = rng.integers(0, 100, (3, 4)).astype(np.int32)
    ib = rng.integers(0, 50, (3, 5)).astype(np.int32)
    jv, ji = jengine._merge_topk_device(
        jnp.asarray(va), jnp.asarray(ia), jnp.asarray(vb), jnp.asarray(ib), 100, 6)
    tv, ti = tengine._merge_topk_device(
        torch.from_numpy(va), torch.from_numpy(ia), torch.from_numpy(vb),
        torch.from_numpy(ib), 100, 6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
