"""parallel/dist_ivf.py of the port, and index="ivf" on a mesh through the
public class, against the JAX package's DistributedIVFIndex and mesh
databases on the 8 virtual CPU devices of tests/conftest.py.

The two packages train different centroids from one seed, so each index
comparison builds the layout once in the JAX package and carries it into the
port (``convert.ivf_state_from_numpy`` + ``IVFIndex.from_state``; through the
public class, the ``"ivf"`` key of db.pkl). Each shard picks its own top-p
lists, so the parity target is JAX's DISTRIBUTED index, not its
single-device one. Tolerances: ids equal where scores are not tied; scores
within 1e-5 for float32 lists and for quantized lists after their exact
float32 rescore, 2e-2 for bfloat16 candidate scores; int8 candidate sets
exactly (K5's plain version: integer dots, the JAX module's two scales in
its order)."""

import numpy as np
import pytest
import torch

from minivectordb_tpu.ops import ivf as jivf
from minivectordb_tpu.parallel import dist_ivf as jdist_ivf
from minivectordb_tpu.parallel import dist_scan as jdist_scan
from minivectordb_tpu.parallel import mesh as jmesh
from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch import VectorDatabase as TorchDB
from minivectordb_tpu_torch.ops import ivf as tivf
from minivectordb_tpu_torch.ops import ivf_probe
from minivectordb_tpu_torch.parallel import dist_ivf as tdist_ivf
from minivectordb_tpu_torch.parallel import dist_scan as tdist_scan
from minivectordb_tpu_torch.parallel.mesh import search_mesh

MASKED = -1.0e38
_IVF_OPTS = {"build_threshold": 4, "nlist": 4, "nprobe": 64, "iters": 4,
             "rebuild_frac": 0.5}


def _mesh(n=8):
    return search_mesh(n, device="cpu")


def _build_corpus(n=512, d=32, clusters=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 4
    mat = centers[rng.integers(0, clusters, n)] + rng.standard_normal((n, d))
    return mat.astype(np.float32)


def _exact_topk(mat, q, k, eligible=None):
    s = (mat @ (q / np.linalg.norm(q))) / np.linalg.norm(mat, axis=1)
    if eligible is not None:
        s[~eligible] = -np.inf
    return set(np.argsort(-s)[:k].tolist())


def _same(tv, ti, jv, ji, atol):
    tv, ti, jv, ji = map(np.asarray, (tv, ti, jv, ji))
    assert tv.shape == jv.shape and ti.shape == ji.shape
    live = jv > MASKED
    assert np.array_equal(tv > MASKED, live)
    np.testing.assert_allclose(tv[live], jv[live], rtol=0, atol=atol)
    for b, j in zip(*np.nonzero((ti != ji) & live)):
        near = [abs(jv[b, j] - jv[b, i]) for i in (j - 1, j + 1)
                if 0 <= i < jv.shape[1] and live[b, i]]
        assert near and min(near) <= 2 * atol, (b, j, ti[b], ji[b])


def _carried_pair(mat, nlist, nprobe, dtype, keep=True, iters=6):
    """A JAX IVFIndex built on ``mat``, its layout carried into the port, and
    both wrapped on 8-shard meshes. Returns (port wrapper, JAX wrapper)."""
    base = jivf.IVFIndex(nlist=nlist, nprobe=nprobe, iters=iters, device_dtype=dtype)
    base.build(mat)
    st = base.state_dict()
    tbase = tivf.IVFIndex.from_state(convert.ivf_state_from_numpy(st), mat, device="cpu")
    t = tdist_ivf.DistributedIVFIndex(_mesh(), tbase, keep_single_device_rescore=keep)
    j = jdist_ivf.DistributedIVFIndex(jmesh.search_mesh(8), base,
                                      keep_single_device_rescore=keep)
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dist_ivf_exhaustive_probe_matches_exact_and_jax(dtype):
    n, d = 4096, 32
    mat = _build_corpus(n, d=d, clusters=32, seed=7)
    t, j = _carried_pair(mat, 32, 32, dtype)
    assert t.nlist == j.nlist and t._local_lists == j._local_lists
    q = np.random.default_rng(11).standard_normal((8, d)).astype(np.float32)
    tv, ti = t.search(q, 10, nprobe=t.nlist)  # exhaustive
    jv, ji = j.search(q, 10, nprobe=j.nlist)
    _same(tv, ti, jv, ji, 1e-5)
    for b in range(8):
        assert set(ti[b].tolist()) == _exact_topk(mat, q[b], 10)


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dist_ivf_partial_probe_matches_jax(dtype, batch):
    """nprobe = 16 of 64 lists over 8 shards: each shard probes its own top
    two lists; the port's per-shard probe (K3 for float32 / bfloat16, K5 on
    grouped pairs for int8, plain versions here) picks the JAX module's
    candidates. Quantized lists rescore exactly afterwards."""
    n, d, k = 8192, 32, 10
    mat = _build_corpus(n, d=d, clusters=64, seed=3)
    t, j = _carried_pair(mat, 64, 16, dtype, iters=8)
    q = np.random.default_rng(5).standard_normal((batch, d)).astype(np.float32)
    tv, ti = t.search(q, k, nprobe=16)
    jv, ji = j.search(q, k, nprobe=16)
    _same(tv, ti, jv, ji, 1e-5)
    oracle = [_exact_topk(mat, q[b], k) for b in range(batch)]
    rec = sum(len(set(ti[b].tolist()) & oracle[b]) for b in range(batch))
    assert rec >= 0.8 * batch * k


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dist_ivf_shard_candidates_match_the_plain_formulation(dtype):
    """Each shard's quantized candidate stage, before the merge and the
    rescore: the route of the search (K3 / K5 on grouped pairs; their plain
    versions here) against the JAX module's per-shard formulation written
    plainly — the top-1 local list, every slot, its mask. int8 exactly;
    bfloat16 within 1e-5 (float32 sums of exact bf16 products)."""
    n, d = 4096, 32
    mat = _build_corpus(n, d=d, clusters=32, seed=17)
    t, _ = _carried_pair(mat, 32, 8, dtype)
    snap = t.snapshot()
    q = np.random.default_rng(19).standard_normal((16, d)).astype(np.float32)
    qn = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))
    qi, qinv = ivf_probe.quantize_queries_ivf(qn) if dtype == "int8" else (None, None)
    p = 1
    for jj in range(len(snap.shards)):
        v, i = snap._shard_candidates(jj, qn, qi, qinv, p, 40)
        # the shard's own lists only: every live id lies in its lists
        lists_ids = snap.tables[1][jj][snap.tables[2][jj]]
        live = v > MASKED
        assert torch.isin(i[live], lists_ids).all()
        # plain formulation of the same shard: its top-1 list, every slot
        lists = snap.tables[0][jj].to(torch.float32)
        cs = torch.where(snap.cent_live[jj], qn @ snap.cent[jj].T, -3.0e38)
        top = cs.argmax(dim=1)
        for b in range(4):
            blk = lists[top[b]]
            if dtype == "int8":
                s = (blk @ qi[b]) * snap.list_inv[jj][top[b]] * qinv[b]
            else:
                s = blk @ qn[b].to(snap.tables[0][jj].dtype).to(torch.float32)
            s = torch.where(snap.tables[2][jj][top[b]], s, -3.0e38)
            want = torch.sort(s, descending=True).values[:40]
            atol = 0.0 if dtype == "int8" else 1e-5
            assert torch.allclose(v[b], want, rtol=0, atol=atol)


def test_dist_ivf_pads_lists_to_the_mesh_and_masks_them():
    """12 trained lists (more after skew splitting) over 8 shards leave
    dead padding lists. Their zero centroids score 0 and would displace a
    real list that scores below 0; cent_live keeps them out, so nprobe =
    nlist stays exact and the probe agrees with JAX's."""
    n, d = 1024, 16
    mat = _build_corpus(n, d=d, clusters=12, seed=23)
    t, j = _carried_pair(mat, 12, 12, "float32")
    # skew splitting may add lists; whatever their number, some are padding
    assert t._local_lists * 8 > t.nlist
    assert int(sum(c.sum() for c in t._cent_live)) == t.nlist
    q = np.random.default_rng(29).standard_normal((6, d)).astype(np.float32)
    for nprobe in (12, 4):
        tv, ti = t.search(q, 10, nprobe=nprobe)
        jv, ji = j.search(q, 10, nprobe=nprobe)
        _same(tv, ti, jv, ji, 1e-5)
    tv, ti = t.search(q, 10, nprobe=12)
    for b in range(6):
        assert set(ti[b].tolist()) == _exact_topk(mat, q[b], 10)


def test_dist_ivf_partial_probe_recall_comparable():
    n, d, k = 8192, 32, 10
    mat = _build_corpus(n, d=d, clusters=64, seed=3)
    base = tivf.IVFIndex(nlist=64, nprobe=16, iters=8, device="cpu")
    base.build(mat)
    q = np.random.default_rng(5).standard_normal((16, d)).astype(np.float32)
    _, sids = base.search(q, k, nprobe=16)
    dist = tdist_ivf.DistributedIVFIndex(_mesh(), base)
    assert base._lists is None  # the wrapper took the list tensor
    _, dids = dist.search(q, k, nprobe=16)
    oracle = [_exact_topk(mat, q[b], k) for b in range(16)]
    rec_s = sum(len(set(sids[b].tolist()) & oracle[b]) for b in range(16))
    rec_d = sum(len(set(dids[b].tolist()) & oracle[b]) for b in range(16))
    assert rec_d >= rec_s - 0.1 * 16 * k, (rec_d, rec_s)


def test_mesh_db_with_ivf_index_end_to_end(tmp_path):
    db = TorchDB(storage_file=str(tmp_path / "e.pkl"), mesh=_mesh(), index="ivf",
                 ivf_opts={**_IVF_OPTS, "build_threshold": 64, "nlist": 16})
    mat = _build_corpus(512, d=32, clusters=16, seed=2)
    db.store_embeddings_batch(list(range(512)), mat)
    ids, scores, metas = db.find_most_similar(mat[9], k=5)
    assert isinstance(db._engine._ivf, tdist_ivf.DistributedIVFIndex)
    assert ids[0] == 9
    # overflow insert still searchable on the mesh path
    far = np.full(32, 50.0, np.float32)
    db.store_embedding(9999, far)
    ids2, _, _ = db.find_most_similar(far, k=2)
    assert ids2[0] == 9999
    # the async path merges the overflow on the device
    got = db.find_most_similar_batch_async(np.stack([far, mat[9]]), k=2).result()
    assert got[0][0][0] == 9999 and got[1][0][0] == 9


@pytest.mark.parametrize("lists_dtype", ["float32", "bfloat16", "int8"])
def test_mesh_ivf_db_matches_jax_mesh_db_on_a_carried_layout(lists_dtype, tmp_path):
    """The JAX mesh database builds and persists; the port's mesh database
    loads that db.pkl (its "ivf" layout) and both serve the same hits at the
    default nprobe, filtered and not, before and after deletes."""
    rng = np.random.default_rng(31)
    mat = _build_corpus(3000, d=32, clusters=24, seed=31)
    metas = [{"keep": bool(i % 4), "i": i} for i in range(3000)]
    path = str(tmp_path / "carried.pkl")
    opts = {"build_threshold": 64, "nlist": 24, "nprobe": 4, "iters": 5,
            "lists_dtype": lists_dtype, "filtered_min_frac": 0.5,
            "rebuild_frac": 10.0, "rebuild_floor": 10_000}
    jdb = JaxDB(storage_file=path, index="ivf", mesh=jmesh.search_mesh(8), ivf_opts=opts)
    jdb.store_embeddings_batch(list(range(3000)), mat, metas)
    jdb.find_most_similar(mat[0], k=1)  # build
    jdb.persist_to_disk()
    tdb = TorchDB(storage_file=path, index="ivf", mesh=_mesh(), ivf_opts=opts)
    assert tdb.stats()["ivf"]["pending_attach"]
    q = rng.standard_normal((12, 32)).astype(np.float32) * 4
    for kw in ({}, {"metadata_filter": {"keep": True}}):
        got = tdb.find_most_similar_batch(q, k=8, **kw)
        want = jdb.find_most_similar_batch(q, k=8, **kw)
        for (gi, gs, _), (wi, ws, _) in zip(got, want):
            _same(np.asarray([gs], np.float32), np.asarray([gi]),
                  np.asarray([ws], np.float32), np.asarray([wi]), 1e-5)
    assert "ivf_build" not in tdb.stats()["ops"]
    assert isinstance(tdb._engine._ivf, tdist_ivf.DistributedIVFIndex)
    for db in (tdb, jdb):
        for uid in range(0, 60, 3):
            db.delete_embedding(uid)
    got = tdb.find_most_similar_batch(q, k=8)
    want = jdb.find_most_similar_batch(q, k=8)
    assert [g[0] for g in got] == [w[0] for w in want]


def test_mesh_ivf_delete_remaps_in_place_no_retrain(tmp_path):
    """A delete on a mesh IVF database tombstones + remaps the sharded id
    tables; no rebuild, no reshard."""
    db = TorchDB(storage_file=str(tmp_path / "d.pkl"), mesh=_mesh(), index="ivf",
                 ivf_opts={**_IVF_OPTS, "build_threshold": 64, "nlist": 16,
                           "rebuild_frac": 10.0, "rebuild_floor": 10_000})
    mat = _build_corpus(512, d=32, clusters=16, seed=4)
    db.store_embeddings_batch(list(range(512)), mat)
    db.find_most_similar(mat[0], k=1)  # trigger build
    eng = db._engine
    dist = eng._ivf
    assert isinstance(dist, tdist_ivf.DistributedIVFIndex)
    lists_before = dist._tables[0]
    for uid in range(0, 60):
        db.delete_embedding(uid)
    assert eng._ivf is dist
    assert dist._tables[0] is lists_before
    assert dist.count == 512 - 60
    ids, _, _ = db.find_most_similar(mat[100], k=8)
    assert ids[0] == 100
    assert all(uid >= 60 for uid in ids)
    assert db.stats()["ops"]["ivf_build"]["count"] == 1
    # a snapshot taken before a delete stays internally consistent
    snap = dist.snapshot()
    with eng.lock:
        snap.attach_sharded_rescore(eng._index_snapshot())
    db.delete_embedding(100)
    vals, rows = snap.search(mat[101][None, :], 5)
    assert rows.shape == (1, 5)
    st = dist.state_dict()
    assert st["count"] == 512 - 61 and st["list_ids"].shape[0] == dist.nlist


@pytest.mark.parametrize("lists_dtype", ["bfloat16", "int8"])
def test_mesh_quantized_ivf_sharded_rescore_matches_exact(lists_dtype, tmp_path):
    """Quantized lists on a float32 mesh engine rescore against the
    ROW-SHARDED exact-scan buffer: the store's build buffer is freed, the
    wrapper holds no corpus, and an exhaustive probe stays EXACT."""
    db = TorchDB(storage_file=str(tmp_path / "q.pkl"), mesh=_mesh(), index="ivf",
                 ivf_opts={**_IVF_OPTS, "build_threshold": 64, "nlist": 16,
                           "nprobe": 64, "lists_dtype": lists_dtype})
    mat = _build_corpus(600, d=32, clusters=16, seed=6)
    db.store_embeddings_batch(list(range(600)), mat)
    q = _build_corpus(5, d=32, clusters=16, seed=7)
    for b in range(5):
        ids, scores, _ = db.find_most_similar(q[b], k=10)
        assert set(ids) == _exact_topk(mat, q[b], 10)
        qs = q[b] / np.linalg.norm(q[b])
        row = mat[ids[0]] / np.linalg.norm(mat[ids[0]])
        assert abs(scores[0] - float(qs @ row)) < 1e-5
    eng = db._engine
    assert isinstance(eng._ivf, tdist_ivf.DistributedIVFIndex)
    assert eng._ivf._data is None  # no single-device corpus retained
    assert eng.store._buf is None  # build buffer freed (release_device)


def test_mesh_quantized_ivf_sharded_rescore_filtered(tmp_path):
    """Broad filters ride the probe on the sharded-rescore path: the mask
    applies to the merged candidates before the rescore cut."""
    db = TorchDB(storage_file=str(tmp_path / "f.pkl"), mesh=_mesh(), index="ivf",
                 ivf_opts={**_IVF_OPTS, "build_threshold": 64, "nlist": 16,
                           "nprobe": 64, "lists_dtype": "int8",
                           "filtered_min_frac": 0.25})
    mat = _build_corpus(600, d=32, clusters=16, seed=8)
    db.store_embeddings_batch(list(range(600)), mat,
                              [{"keep": bool(i % 4)} for i in range(600)])
    q = _build_corpus(4, d=32, clusters=16, seed=9)
    eligible = np.array([bool(i % 4) for i in range(600)])
    before = db.stats()["ops"].get("ivf_scan", {}).get("count", 0)
    for b in range(4):
        ids, _, metas = db.find_most_similar(q[b], k=8, metadata_filter={"keep": True})
        assert all(m["keep"] for m in metas)
        assert set(ids) == _exact_topk(mat, q[b], 8, eligible)
    assert db.stats()["ops"]["ivf_scan"]["count"] >= before + 4


def test_mesh_quantized_ivf_sharded_rescore_survives_delete(tmp_path):
    db = TorchDB(storage_file=str(tmp_path / "s.pkl"), mesh=_mesh(), index="ivf",
                 ivf_opts={**_IVF_OPTS, "build_threshold": 64, "nlist": 16,
                           "nprobe": 64, "lists_dtype": "bfloat16",
                           "rebuild_frac": 10.0, "rebuild_floor": 10_000})
    mat = _build_corpus(512, d=32, clusters=16, seed=10)
    db.store_embeddings_batch(list(range(512)), mat)
    db.find_most_similar(mat[0], k=1)  # build
    for uid in range(0, 50):
        db.delete_embedding(uid)
    live = mat[50:]
    q = _build_corpus(4, d=32, clusters=16, seed=11)
    for b in range(4):
        ids, _, _ = db.find_most_similar(q[b], k=10)
        assert set(ids) == {i + 50 for i in _exact_topk(live, q[b], 10)}


def test_dist_ivf_sharded_only_requires_attach():
    """Without a rescore corpus the snapshot refuses to search; an attached
    float32 exact-scan snapshot restores exact results, and JAX's wrapper
    on the same layout agrees."""
    n, d = 2048, 32
    mat = _build_corpus(n, d=d, clusters=32, seed=12)
    t, j = _carried_pair(mat, 32, 32, "int8", keep=False)
    assert t._data is None
    q = _build_corpus(4, d=d, clusters=32, seed=13)
    snap = t.snapshot()
    with pytest.raises(RuntimeError, match="attach_sharded_rescore"):
        snap.search(q, 10)
    # a bf16 buffer, another mesh, or a short corpus cannot serve
    bf = tdist_scan.DistributedScanIndex(t.mesh, d, device_dtype="bfloat16")
    bf.load(mat)
    assert not snap.attach_sharded_rescore(bf.snapshot())
    other = tdist_scan.DistributedScanIndex(_mesh(), d)
    other.load(mat)
    assert not snap.attach_sharded_rescore(other.snapshot())
    scan = tdist_scan.DistributedScanIndex(t.mesh, d)
    scan.load(mat[:100])
    assert not snap.attach_sharded_rescore(scan.snapshot())
    scan.load(mat)
    assert snap.attach_sharded_rescore(scan.snapshot())
    tv, ti = snap.search(q, 10, nprobe=t.nlist)  # exhaustive
    jscan = jdist_scan.DistributedScanIndex(j.mesh, d)
    jscan.load(mat)
    jsnap = j.snapshot()
    assert jsnap.attach_sharded_rescore(jscan.snapshot())
    jv, ji = jsnap.search(q, 10, nprobe=j.nlist)
    _same(tv, ti, jv, ji, 1e-5)
    for b in range(4):
        assert set(ti[b].tolist()) == _exact_topk(mat, q[b], 10)


def test_mesh_quantized_ivf_non_f32_engine_skips_sharded_corpus(tmp_path):
    """A bf16/int8 mesh engine keeps the wrapper's single-device rescore
    corpus, and builds no distributed exact-scan buffer on the IVF path."""
    db = TorchDB(storage_file=str(tmp_path / "n.pkl"), mesh=_mesh(), device_dtype="int8",
                 index="ivf", ivf_opts={**_IVF_OPTS, "build_threshold": 64,
                                        "nlist": 16, "nprobe": 16,
                                        "lists_dtype": "int8"})
    mat = _build_corpus(600, d=32, clusters=16, seed=20)
    db.store_embeddings_batch(list(range(600)), mat)
    q = _build_corpus(2, d=32, clusters=16, seed=21)
    db.find_most_similar(q[0], k=10)
    eng = db._engine
    assert eng._ivf._data is not None
    assert eng._dist is None
    ids, _, _ = db.find_most_similar(q[1], k=10, nprobe=16)
    assert len(ids) == 10


def _mk_mesh_db(path, n=4000, seed=20, **opts):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 4
    labels = rng.integers(0, 16, n)
    mat = (centers[labels] + rng.standard_normal((n, 32))).astype(np.float32)
    db = TorchDB(str(path), index="ivf", mesh=_mesh(),
                 ivf_opts={"build_threshold": 64, "nlist": 16, "nprobe": 64,
                           "iters": 4, **opts})
    metas = [{"i": int(i), "cluster": int(labels[i])} for i in range(n)]
    db.store_embeddings_batch(list(range(n)), mat, metas)
    return db, mat, labels


def _counts(db):
    ops = db.stats()["ops"]
    return (ops.get("ivf_scan", {}).get("count", 0),
            ops.get("device_scan", {}).get("count", 0))


def test_mesh_broad_filter_rides_ivf(tmp_path):
    db, mat, labels = _mk_mesh_db(tmp_path / "b.pkl")
    filt = {"cluster": {"$lte": 11}}  # ~75% pass
    eligible = labels <= 11
    rng = np.random.default_rng(21)
    hits = want = 0
    for q in rng.standard_normal((12, mat.shape[1])).astype(np.float32):
        ids, scores, metas = db.find_most_similar(q, k=10, metadata_filter=filt)
        assert len(ids) == 10
        assert all(m["cluster"] <= 11 for m in metas)
        hits += len(set(ids) & _exact_topk(mat, q, 10, eligible))
        want += 10
    assert hits / want >= 0.95
    ivf_n, _ = _counts(db)
    assert ivf_n >= 12


def test_mesh_shortfall_falls_back_to_exact(tmp_path):
    """A probe that finds fewer eligible rows than k reruns through the
    distributed exact masked scan: the exact-count contract holds."""
    db, mat, _ = _mk_mesh_db(tmp_path / "s.pkl", nprobe=1, filtered_min_frac=0.001)
    filt = {"i": {"$gte": 3990}}
    eligible = np.arange(len(mat)) >= 3990
    q = np.asarray(mat[50], dtype=np.float32)
    ids, scores, metas = db.find_most_similar(q, k=10, metadata_filter=filt)
    assert len(ids) == 10
    assert set(ids) == _exact_topk(mat, q, 10, eligible)
    ivf_n, exact_n = _counts(db)
    assert ivf_n >= 1 and exact_n >= 1


def test_calibration_on_mesh_database(tmp_path):
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((24, 32)).astype(np.float32) * 4
    mat = (centers[rng.integers(0, 24, 4000)]
           + rng.standard_normal((4000, 32))).astype(np.float32)
    db = TorchDB(str(tmp_path / "c.pkl"), index="ivf", mesh=_mesh(),
                 ivf_opts={"build_threshold": 64, "nlist": 16, "nprobe": 1,
                           "iters": 5, "lists_dtype": "int8"})
    db.store_embeddings_batch(list(range(4000)), mat)
    res = db.calibrate_nprobe(0.95)
    assert res["recall"] >= 0.95
    assert db.nprobe == res["nprobe"]
    assert db._engine.ivf_state()["nprobe_calibrated"]
    ids, _, _ = db.find_most_similar(mat[11], k=5)
    assert ids[0] == 11


def test_mesh_nprobe_equal_configured_nlist_is_exact_despite_splits():
    """Per-shard probe width derives from the widened nprobe, so nprobe =
    configured nlist probes every list on every shard, after skew splitting
    (tests/test_ivf.py:264)."""
    rng = np.random.default_rng(1)
    mat = rng.normal(size=(600, 32)).astype(np.float32)
    base = tivf.IVFIndex(nlist=16, nprobe=16, iters=25, device_dtype="float32",
                         device="cpu")
    base.build(mat)
    assert base.n_dup > 0, "corpus did not trigger splitting; adjust seed"
    dist = tdist_ivf.DistributedIVFIndex(_mesh(), base)
    sn = mat / np.linalg.norm(mat, axis=1, keepdims=True)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    vals, ids = dist.search(q, 10, nprobe=16)
    for b in range(4):
        s = sn @ (q[b] / np.linalg.norm(q[b]))
        assert set(ids[b].tolist()) == set(np.argsort(-s)[:10].tolist())
