"""index="ivf" through the public class: minivectordb_tpu_torch.VectorDatabase
(device="cpu") on its own lifecycle, and against
minivectordb_tpu.VectorDatabase on a layout that crosses between the two in
``db.pkl`` (the two packages train different centroids from the same seed, so
parity goes through carried state). Scores within 2e-5 (float32 sums in
another order), ids equal where scores are not tied."""

import pickle

import numpy as np
import pytest
import torch

from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import VectorDatabase as TorchDB

N, D, K, CENTRES = 3000, 64, 10, 12
OPTS = {"build_threshold": 1000, "iters": 4, "rebuild_frac": 0.2,
        "rebuild_floor": 64, "lists_dtype": "float32"}


def _data(seed=0, n=N):
    """A seeded mixture: CENTRES unit centres plus noise, with the centre of
    each row in its metadata."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((CENTRES, D)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    which = rng.integers(0, CENTRES, size=n)
    rows = (centres[which] + 0.25 * rng.standard_normal((n, D))).astype(np.float32)
    metas = [{"centre": int(c), "bucket": i % 16,
              "parity": "even" if i % 2 == 0 else "odd"}
             for i, c in enumerate(which)]
    queries = (centres[rng.integers(0, CENTRES, size=32)]
               + 0.25 * rng.standard_normal((32, D))).astype(np.float32)
    return centres, rows, metas, queries


def _ivf_db(path, cls=TorchDB, **opts):
    kw = {"device": "cpu"} if cls is TorchDB else {}
    return cls(storage_file=str(path), index="ivf", nlist=CENTRES, nprobe=3,
               ivf_opts={**OPTS, **opts}, **kw)


def _flat_db(path, rows, metas, ids=None):
    db = TorchDB(storage_file=str(path), device="cpu")
    db.store_embeddings_batch(list(range(len(rows))) if ids is None else ids, rows, metas)
    return db


def _same_hits(got, want, atol=2e-5):
    assert len(got) == len(want)
    for (g_ids, g_s, g_md), (w_ids, w_s, w_md) in zip(got, want):
        assert len(g_ids) == len(w_ids)
        np.testing.assert_allclose(np.asarray(g_s, np.float64),
                                   np.asarray(w_s, np.float64), rtol=0, atol=atol)
        for j, (a, b) in enumerate(zip(g_ids, w_ids)):
            if a != b:  # only where neighbouring scores are tied
                near = [abs(w_s[j] - w_s[i]) for i in (j - 1, j + 1)
                        if 0 <= i < len(w_s)]
                assert min(near) <= 2 * atol, (g_ids, w_ids)
            else:
                assert g_md[j] == w_md[j]


def _ops(db):
    return {k: v["count"] for k, v in db.stats()["ops"].items()}


def test_lifecycle_build_overflow_rebuild_and_deletes(tmp_path):
    _, rows, metas, queries = _data()
    db = _ivf_db(tmp_path / "a.pkl")
    db.store_embeddings_batch(list(range(900)), rows[:900], metas[:900])
    db.find_most_similar_batch(queries, k=K)
    st = db.stats()["ivf"]
    assert st["built"] is False and st["indexed_rows"] == 0
    assert "ivf_scan" not in _ops(db) and _ops(db)["device_scan"] == 1

    # past the threshold the next search builds the index and serves from it
    db.store_embeddings_batch(list(range(900, 2000)), rows[900:2000], metas[900:2000])
    exhaustive = db.find_most_similar_batch(queries, k=K, nprobe=CENTRES)
    st = db.stats()["ivf"]
    assert st["built"] and st["indexed_rows"] == 2000 and st["overflow_rows"] == 0
    assert st["nlist_effective"] >= st["split_duplicates"] + 1
    assert st["lists_dtype"] == "float32" and st["nprobe"] == 3
    assert _ops(db)["ivf_build"] == 1 and _ops(db)["ivf_scan"] == 1
    flat = _flat_db(tmp_path / "f.pkl", rows[:2000], metas[:2000])
    _same_hits(exhaustive, flat.find_most_similar_batch(queries, k=K))

    # rows added after the build are served exactly from the overflow store
    for i, q in enumerate(queries[:5]):
        db.store_embedding(f"new{i}", q, {"centre": -1, "bucket": 99, "parity": "new"})
    st = db.stats()["ivf"]
    assert st["overflow_rows"] == 5 and st["indexed_rows"] == 2000
    hits = db.find_most_similar_batch(queries[:5], k=K)
    assert [h[0][0] for h in hits] == [f"new{i}" for i in range(5)]
    assert all(abs(h[1][0] - 1.0) < 1e-5 for h in hits)
    single = db.find_most_similar(queries[0], k=3)  # paged probe + overflow
    assert single[0][0] == "new0"
    assert _ops(db)["ivf_build"] == 1

    # deletes tombstone slots; the trained index stays
    gone = [int(h[0][1]) for h in hits] + ["new4"]
    for uid in gone:
        db.delete_embedding(uid)
    st = db.stats()["ivf"]
    assert st["built"] and st["dead_slots"] == len(set(gone)) - 1
    after = db.find_most_similar_batch(queries[:5], k=K, nprobe=CENTRES)
    assert not any(u in set(gone) for h in after for u in h[0])
    assert _ops(db)["ivf_build"] == 1
    keep = [i for i in range(2000) if i not in set(gone)]
    flat2 = _flat_db(tmp_path / "f2.pkl",
                     np.concatenate([rows[keep], queries[:4]]),
                     [metas[i] for i in keep] + [{}] * 4,
                     ids=keep + [f"new{i}" for i in range(4)])
    want = flat2.find_most_similar_batch(queries[:5], k=K)
    assert [list(h[0]) for h in after] == [list(h[0]) for h in want]

    # overflow past rebuild_frac folds everything into a fresh build
    db.store_embeddings_batch(list(range(2000, 2600)), rows[2000:2600], metas[2000:2600])
    db.find_most_similar_batch(queries, k=K)
    st = db.stats()["ivf"]
    assert _ops(db)["ivf_build"] == 2
    assert st["overflow_rows"] == 0 and st["dead_slots"] == 0
    assert st["indexed_rows"] == db.stats()["count"] == 2605 - len(set(gone))
    assert db.stats()["tombstoned_rows"] == 0  # the rebuild compacted them


def test_broad_filter_rides_the_probe_and_a_selective_one_does_not(tmp_path):
    _, rows, metas, queries = _data(1)
    db = _ivf_db(tmp_path / "b.pkl")
    db.store_embeddings_batch(list(range(N)), rows, metas)
    flat = _flat_db(tmp_path / "f.pkl", rows, metas)
    db.find_most_similar_batch(queries, k=K)
    before = _ops(db)

    broad = db.find_most_similar_batch(
        queries, k=K, metadata_filter={"parity": "even"}, nprobe=CENTRES)
    mid = _ops(db)
    assert mid["ivf_scan"] == before["ivf_scan"] + 1
    assert mid.get("device_scan", 0) == before.get("device_scan", 0)
    assert all(md["parity"] == "even" for h in broad for md in h[2])
    _same_hits(broad, flat.find_most_similar_batch(
        queries, k=K, metadata_filter={"parity": "even"}))

    narrow = db.find_most_similar_batch(queries, k=K, metadata_filter={"bucket": 3})
    after = _ops(db)
    assert after["ivf_scan"] == mid["ivf_scan"]
    assert after["device_scan"] == mid.get("device_scan", 0) + 1
    _same_hits(narrow, flat.find_most_similar_batch(
        queries, k=K, metadata_filter={"bucket": 3}))

    # a filtered async dispatch keeps the exact masked scan too
    handle = db.find_most_similar_batch_async(
        queries, k=K, metadata_filter={"parity": "even"})
    assert _ops(db)["ivf_scan"] == after["ivf_scan"]
    _same_hits(handle.result(), flat.find_most_similar_batch(
        queries, k=K, metadata_filter={"parity": "even"}))


def test_count_guarantee_on_a_filter_that_follows_the_clusters(tmp_path):
    centres, rows, metas, _ = _data(2)
    db = _ivf_db(tmp_path / "c.pkl")
    db.store_embeddings_batch(list(range(N)), rows, metas)
    flat = _flat_db(tmp_path / "f.pkl", rows, metas)
    # queries sit on centre 0; the filter passes every row EXCEPT centre 0's
    # (11/12 of the corpus: broad, so it rides the probe), and one probed
    # list holds nothing eligible: those rows rerun through the exact scan
    q = np.tile(centres[0], (16, 1)).astype(np.float32)
    q[8:] = centres[5]  # these find their k in the probed list
    flt = {"centre": {"$ne": 0}}
    got = db.find_most_similar_batch(q, k=K, metadata_filter=flt, nprobe=1)
    assert all(len(h[0]) == K for h in got)
    assert all(md["centre"] != 0 for h in got for md in h[2])
    want = flat.find_most_similar_batch(q, k=K, metadata_filter=flt)
    _same_hits(got[:8], want[:8])  # the rerun rows are exact
    ops = _ops(db)
    assert ops["ivf_scan"] >= 1 and ops["device_scan"] >= 1
    # fewer candidates than k: exactly that many come back
    narrow = {"centre": 1, "bucket": 3, "parity": "odd"}
    n_match = sum(all(m[k] == v for k, v in narrow.items()) for m in metas)
    few = db.find_most_similar_batch(q, k=50, metadata_filter=narrow)
    assert 0 < n_match < 50 and all(len(h[0]) == n_match for h in few)
    assert db.find_most_similar_batch(
        q, k=K, metadata_filter={"bucket": 99}) == [([], [], [])] * 16


def test_calibrate_nprobe_and_its_errors(tmp_path):
    _, rows, metas, queries = _data(3)
    flat = TorchDB(storage_file=str(tmp_path / "flat.pkl"), device="cpu")
    with pytest.raises(ValueError, match="requires index='ivf'"):
        flat.calibrate_nprobe()
    db = _ivf_db(tmp_path / "d.pkl", nprobe=1)
    with pytest.raises(ValueError, match="empty"):
        db.calibrate_nprobe()
    db.store_embeddings_batch(list(range(500)), rows[:500], metas[:500])
    with pytest.raises(ValueError, match="build_threshold"):
        db.calibrate_nprobe()
    with pytest.raises(ValueError, match="recall_target"):
        db.calibrate_nprobe(1.5)
    db.store_embeddings_batch(list(range(500, N)), rows[500:], metas[500:])
    assert db.nprobe == 1 and not db.stats()["ivf"]["nprobe_calibrated"]
    out = db.calibrate_nprobe(0.99, queries=queries, k=K)
    assert set(out) == {"nprobe", "recall", "evaluated"}
    assert out["recall"] >= 0.99 and out["nprobe"] & (out["nprobe"] - 1) == 0 \
        or out["nprobe"] == db.stats()["ivf"]["nlist_effective"]
    assert [e["nprobe"] for e in out["evaluated"]][:2] == [1, 2][:len(out["evaluated"])]
    assert db.nprobe == out["nprobe"]
    st = db.stats()["ivf"]
    assert st["nprobe_calibrated"] and st["nprobe"] == out["nprobe"]
    assert db.stats()["ops"]["ivf_build"]["count"] == 1
    # default queries are sampled stored rows; a tensor workload is taken too
    again = db.calibrate_nprobe(0.5, sample=16, seed=1)
    assert again["nprobe"] <= out["nprobe"]
    assert db.calibrate_nprobe(0.5, queries=torch.from_numpy(queries))["recall"] >= 0.5
    # the calibrated width travels with the pickle
    db.persist_to_disk()
    back = _ivf_db(tmp_path / "d.pkl")
    back.find_most_similar(queries[0], k=K)
    assert back.nprobe == db.nprobe and back.stats()["ivf"]["nprobe_calibrated"]


def test_recall_target_calibrates_every_build(tmp_path):
    _, rows, metas, queries = _data(4)
    db = _ivf_db(tmp_path / "e.pkl", nprobe=1, recall_target=0.95)
    db.store_embeddings_batch(list(range(N)), rows, metas)
    db.find_most_similar_batch(queries, k=K)
    st = db.stats()
    assert st["ivf"]["nprobe_calibrated"] and st["ivf"]["nprobe"] == db.nprobe
    assert st["ops"]["nprobe_calibration"]["count"] == 1
    flat = _flat_db(tmp_path / "f.pkl", rows, metas)
    want = flat.find_most_similar_batch(queries, k=K)
    got = db.find_most_similar_batch(queries, k=K)
    hit = np.mean([len(set(g[0]) & set(w[0])) / K for g, w in zip(got, want)])
    assert hit >= 0.9, hit


def test_per_call_nprobe_and_its_validation(tmp_path):
    _, rows, metas, queries = _data(5)
    db = _ivf_db(tmp_path / "g.pkl", nprobe=1)
    db.store_embeddings_batch(list(range(N)), rows, metas)
    flat = _flat_db(tmp_path / "f.pkl", rows, metas)
    want = flat.find_most_similar_batch(queries, k=K)
    _same_hits(db.find_most_similar_batch(queries, k=K, nprobe=np.int64(CENTRES)), want)
    _same_hits([db.find_most_similar(queries[0], k=K, nprobe=CENTRES)], want[:1])
    narrow = db.find_most_similar_batch(queries, k=K)
    hit = np.mean([len(set(g[0]) & set(w[0])) / K for g, w in zip(narrow, want)])
    assert 0.3 < hit <= 1.0
    assert db._engine.ivf_opts["nprobe"] == 1  # the configured one, untouched
    for bad in (0, -2, True, 1.5, "4"):
        with pytest.raises(ValueError, match="positive integer"):
            db.find_most_similar_batch(queries, k=K, nprobe=bad)
    db.nprobe = CENTRES
    _same_hits(db.find_most_similar_batch(queries, k=K), want)
    auto = _ivf_db(tmp_path / "h.pkl", nlist="auto")
    auto.store_embeddings_batch(list(range(N)), rows, metas)
    auto.find_most_similar_batch(queries, k=K)
    # 4 * sqrt(3000) = 219 -> 256 lists asked for; empty ones are dropped
    assert 32 <= auto.stats()["ivf"]["nlist_effective"] <= 256 + auto.stats()["ivf"]["split_duplicates"]
    with pytest.raises(ValueError):
        TorchDB(storage_file=str(tmp_path / "i.pkl"), index="hnsw", device="cpu")


def test_async_handles_and_tensor_queries(tmp_path):
    _, rows, metas, queries = _data(6)
    db = _ivf_db(tmp_path / "j.pkl")
    db.store_embeddings_batch(list(range(N)), rows, metas)
    db.warmup(k=K, batch=16)
    assert db.stats()["ivf"]["built"]
    want = db.find_most_similar_batch(queries, k=K)
    handles = [db.find_most_similar_batch_async(queries[i:i + 16], k=K) for i in (0, 16)]
    _same_hits(handles[0].result() + handles[1].result(), want)
    _same_hits(db.find_most_similar_batch(torch.from_numpy(queries), k=K), want)
    # with overflow rows a deferred search merges on the device
    for i in range(3):
        db.store_embedding(f"o{i}", queries[i], {})
    want = db.find_most_similar_batch(queries, k=K)
    assert [h[0][0] for h in want[:3]] == ["o0", "o1", "o2"]
    handle = db.find_most_similar_batch_async(queries, k=K)
    db.delete_embedding("o0")  # after dispatch: the handle keeps its snapshot
    _same_hits(handle.result(), want)
    assert db.find_most_similar(queries[0], k=1)[0][0] != "o0"


def test_every_indexed_row_tombstoned_under_the_rebuild_floor(tmp_path):
    _, rows, metas, queries = _data(7, n=1200)
    db = _ivf_db(tmp_path / "k.pkl", rebuild_frac=1e9, rebuild_floor=10_000)
    db.store_embeddings_batch(list(range(1200)), rows, metas)
    db.find_most_similar_batch(queries, k=K)
    db.store_embedding("late", queries[0], {})
    eng = db._engine
    with eng.lock:
        eng.delete_many(list(range(1200)))
    assert db.stats()["ivf"]["built"]
    got = db.find_most_similar_batch(queries[:4], k=K)
    assert [list(h[0]) for h in got] == [["late"]] * 4
    assert db.find_most_similar_batch_async(queries[:4], k=K).result() == got


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """One corpus indexed by each package and persisted, per lists dtype."""
    _, rows, metas, queries = _data(8)
    out = {"rows": rows, "metas": metas, "queries": queries}
    for dtype in ("float32", "bfloat16"):
        tmp = tmp_path_factory.mktemp("x" + dtype)
        paths = {}
        for name, cls in (("jax", JaxDB), ("torch", TorchDB)):
            db = _ivf_db(tmp / f"{name}.pkl", cls=cls, lists_dtype=dtype)
            db.store_embeddings_batch(list(range(N)), rows, metas)
            db.find_most_similar_batch(queries, k=K)  # builds
            for uid in (3, 4, 5):
                db.delete_embedding(uid)
            db.persist_to_disk()
            paths[name] = str(tmp / f"{name}.pkl")
        out[dtype] = paths
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_an_ivf_pickle_loads_in_the_other_package_and_serves_the_same_hits(
        crossed, dtype, writer):
    path = crossed[dtype][writer]
    with open(path, "rb") as f:
        raw = f.read()
    assert b"torch" not in raw and b"jax" not in raw and b"minivectordb" not in raw
    data = pickle.loads(raw)
    assert set(data) == {"embeddings", "metadata", "id_map", "inverse_id_map",
                         "inverted_index", "ivf"}
    st = data["ivf"]
    assert type(st["centroids"]) is np.ndarray and st["centroids"].dtype == np.float32
    assert st["list_ids"].dtype == np.int32 and st["list_valid"].dtype == np.bool_
    assert st["count"] == N - 3 and st["device_dtype"] == dtype
    assert int(st["list_valid"].sum()) == N - 3

    queries = crossed["queries"]
    jdb = _ivf_db(path, cls=JaxDB, lists_dtype=dtype)
    tdb = _ivf_db(path, cls=TorchDB, lists_dtype=dtype)
    for db in (jdb, tdb):
        assert db.stats()["ivf"]["pending_attach"] and not db.stats()["ivf"]["built"]
    for q, kw in ((queries, {}), (queries[:4], {}), (queries, {"nprobe": 1}),
                  (queries, {"metadata_filter": {"parity": "even"}})):
        _same_hits(tdb.find_most_similar_batch(q, k=K, **kw),
                   jdb.find_most_similar_batch(q, k=K, **kw))
    js, ts = jdb.stats(), tdb.stats()
    assert ts["ivf"] == js["ivf"] and ts["ivf"]["built"]
    # reattached from the pickle: one scatter, no k-means
    assert "ivf_build" not in ts["ops"] and ts["ops"]["ivf_attach"]["count"] == 1
    assert tdb.calibrate_nprobe(0.9, queries=queries) == jdb.calibrate_nprobe(
        0.9, queries=queries)
    # and each writes back a layout the other reads
    assert set(tdb._engine.ivf_state()) == set(jdb._engine.ivf_state())


def test_a_flat_database_carries_a_loaded_layout_through(crossed, tmp_path):
    """index="flat" has no use for the key but does not drop it."""
    import shutil

    path = str(tmp_path / "copy.pkl")
    shutil.copy(crossed["float32"]["jax"], path)
    db = TorchDB(storage_file=path, device="cpu")
    assert "ivf" not in db.stats()
    db.find_most_similar_batch(crossed["queries"], k=K)
    db.persist_to_disk()
    with open(path, "rb") as f:
        assert pickle.load(f)["ivf"]["count"] == N - 3


def test_delete_of_an_overflow_row_past_the_device_capacity_matches_jax(tmp_path):
    """Fault F1 on the IVF overflow store: the row "X" appended after the last
    sync lies past the device alive mask. Its delete must succeed, and the
    filtered search after it must not return it (the reference returns
    (1100, 2900))."""
    rng = np.random.default_rng(12)
    d = 16
    opts = {"build_threshold": 2000, "nlist": 8, "nprobe": 8, "iters": 3,
            "rebuild_frac": 10.0}
    first = rng.standard_normal((2000, d)).astype(np.float32)
    more = rng.standard_normal((1024, d)).astype(np.float32)
    v_x = rng.standard_normal(d).astype(np.float32)
    flt = {"tag": "rare"}
    out = {}
    for cls in (JaxDB, TorchDB):
        kw = {"device": "cpu"} if cls is TorchDB else {}
        db = cls(storage_file=str(tmp_path / f"{cls.__module__}.pkl"), index="ivf",
                 ivf_opts=dict(opts), **kw)
        db.store_embeddings_batch(list(range(2000)), first,
                                  [{"tag": "rare" if i % 50 == 0 else "common"}
                                   for i in range(2000)])
        db.find_most_similar(first[0], k=3)  # builds the index
        db.store_embeddings_batch(list(range(2000, 3024)), more,
                                  [{"tag": "rare" if i % 50 == 0 else "common"}
                                   for i in range(2000, 3024)])
        db.delete_embedding(2500)
        db.find_most_similar(first[1], k=3)
        db.store_embedding("X", v_x, {"tag": "rare"})
        before = db.find_most_similar(v_x, k=2, metadata_filter=flt)
        db.delete_embedding("X")
        after = db.find_most_similar(v_x, k=2, metadata_filter=flt)
        out[cls] = (before, after, len(db.id_map))
    (jb, ja, jn), (tb, ta, tn) = out[JaxDB], out[TorchDB]
    assert tn == jn == 3023
    assert list(tb[0]) == list(jb[0]) and tb[0][0] == "X"
    assert "X" not in ta[0]
    assert list(ta[0]) == list(ja[0])
    np.testing.assert_allclose(np.asarray(ta[1], np.float64), np.asarray(ja[1], np.float64),
                               rtol=0, atol=2e-5)
