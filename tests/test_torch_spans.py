"""The port's span log (utils/telemetry.py): spans record only while a
torch.profiler runs, nest per thread under one request id, lie on the
clock of the profiler's events (time.time_ns), and are fed from the engine,
the text API and the single-card training step. Also the repaired
``device_scan`` timing of deferred searches."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minivectordb_tpu_torch import EmbeddingModel, VectorDatabase
from minivectordb_tpu_torch.models import train as ttrain
from minivectordb_tpu_torch.models.encoder import EncoderConfig, init_params
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.utils import telemetry

ROWS, DIM = 6000, 32


@pytest.fixture(autouse=True)
def empty_log():
    telemetry.clear_spans()
    yield
    telemetry.clear_spans()


@pytest.fixture(scope="module")
def vecs():
    return np.random.default_rng(0).standard_normal((ROWS, DIM)).astype(np.float32)


def _db(tmp_path, vecs, **kw):
    """A flat database of the rows (``index="ivf"`` in ``kw``: an IVF one
    past its build threshold)."""
    if kw.get("index") == "ivf":
        kw = {"nlist": 12, "nprobe": 3,
              "ivf_opts": {"build_threshold": 1000, "iters": 4, "lists_dtype": "float32"},
              **kw}
    db = VectorDatabase(storage_file=str(tmp_path / "db.pkl"), device="cpu", **kw)
    db.store_embeddings_batch(list(range(ROWS)), vecs, [{"idx": i % 7} for i in range(ROWS)])
    return db


@pytest.fixture(scope="module")
def model():
    return EmbeddingModel(device="cpu")


def _train_setup():
    cfg = EncoderConfig(vocab_size=256, hidden=32, layers=2, heads=4, intermediate=64)
    enc = init_params(cfg, torch.Generator().manual_seed(0))
    encoder, opt_state, optimizer = ttrain.init_training(cfg, enc, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 256, (4, 16), dtype=np.int32)
    batch = {"q_ids": ids, "q_mask": np.ones_like(ids), "p_ids": ids, "p_mask": np.ones_like(ids)}
    return ttrain.make_train_step(cfg, optimizer), encoder, opt_state, batch


def _traced(fn):
    """Run ``fn`` inside a profiler; returns (result, spans, t0, t1) with
    t0/t1 read on time.time_ns around the call."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    return out, telemetry.spans(), t0, t1


def _tree(recs):
    """name -> list of records, and the record of each span id."""
    by_name, by_id = {}, {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
        by_id[r.span_id] = r
    return by_name, by_id


def _parent(r, by_id):
    return by_id[r.parent_id].name if r.parent_id is not None else None


def test_the_profiler_flag_is_what_spans_read():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
    assert not torch.autograd.profiler._is_profiler_enabled


def test_off_a_span_is_one_shared_no_op():
    assert telemetry.span("a") is telemetry.span("b", device=True)
    with telemetry.span("a") as s:
        assert s is None
    assert telemetry.current_request() is None
    assert telemetry.spans() == []


def test_no_span_is_recorded_outside_a_profiler(tmp_path, vecs, model):
    db = _db(tmp_path, vecs, search_mode="approx")
    db.find_most_similar(vecs[3], k=5)
    db.find_most_similar_batch(vecs[:32], k=5)
    db.find_most_similar_batch_async(vecs[:32], k=5).result()
    model.extract_embeddings_batch(["i like dogs", "cars"])
    step, enc, opt, batch = _train_setup()
    step(enc, opt, batch)
    assert telemetry.spans() == []
    assert telemetry.spans_dropped() == 0


@pytest.mark.parametrize("route", ["device", "host"])
def test_a_search_is_one_request_of_nested_spans(tmp_path, vecs, route):
    # "approx" never takes the host BLAS route, so the result pair is fetched
    db = _db(tmp_path, vecs, search_mode="approx" if route == "device" else "exact")
    db.find_most_similar(vecs[3], k=5)
    _, recs, t0, t1 = _traced(lambda: db.find_most_similar(vecs[3], k=5))
    by_name, by_id = _tree(recs)
    want = {"search", "search.filter", "search.scan", "search.format"}
    if route == "device":
        want.add("search.fetch")
    assert set(by_name) == want
    assert all(len(v) == 1 for v in by_name.values())
    assert _parent(by_name["search"][0], by_id) is None
    for name in ("search.filter", "search.scan", "search.format"):
        assert _parent(by_name[name][0], by_id) == "search"
    if route == "device":
        assert _parent(by_name["search.fetch"][0], by_id) == "search.scan"
    assert len({r.request_id for r in recs}) == 1
    assert len({r.thread_id for r in recs}) == 1
    for r in recs:
        assert t0 <= r.start_ns <= r.end_ns <= t1, r
        assert r.device_ms is None
    root = by_name["search"][0]
    for r in recs:
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns


def test_a_batch_search_spans_once_per_call(tmp_path, vecs):
    db = _db(tmp_path, vecs)
    db.find_most_similar_batch(vecs[:32], k=5)

    def calls():
        for lo in (0, 32, 64):
            db.find_most_similar_batch(vecs[lo:lo + 32], k=5)

    _, recs, t0, t1 = _traced(calls)
    by_name, by_id = _tree(recs)
    assert {n: len(v) for n, v in by_name.items()} == {
        "search": 3, "search.filter": 3, "search.scan": 3, "search.fetch": 3, "search.format": 3}
    assert len({r.request_id for r in recs}) == 3
    for root in by_name["search"]:
        kids = [r for r in recs if r.request_id == root.request_id and r is not root]
        assert sorted(r.name for r in kids) == [
            "search.fetch", "search.filter", "search.format", "search.scan"]
        assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in kids)


def test_a_search_with_a_filter_per_query_spans_each_group(tmp_path, vecs):
    db = _db(tmp_path, vecs)
    filters = [{"idx": i % 2} for i in range(32)]
    _, recs, _, _ = _traced(
        lambda: db.find_most_similar_batch(vecs[:32], k=5, metadata_filters=filters))
    by_name, by_id = _tree(recs)
    assert len(by_name["search"]) == 1
    for name in ("search.filter", "search.scan", "search.fetch", "search.format"):
        assert len(by_name[name]) == 2, name
    # the two groups are drained after both are dispatched, under the root
    assert {_parent(r, by_id) for r in by_name["search.fetch"]} == {"search"}
    assert len({r.request_id for r in recs}) == 1


def test_an_async_result_carries_its_dispatch_request(tmp_path, vecs):
    db = _db(tmp_path, vecs)

    def calls():
        a = db.find_most_similar_batch_async(vecs[:32], k=5)
        b = db.find_most_similar_batch_async(vecs[32:64], k=5)
        return b.result(), a.result()

    _, recs, t0, t1 = _traced(calls)
    by_name, by_id = _tree(recs)
    dispatches = sorted(by_name["search"], key=lambda r: r.start_ns)
    results = sorted(by_name["search.result"], key=lambda r: r.start_ns)
    assert len(dispatches) == 2 and len(results) == 2
    # drained in the other order: b's result first, under b's id
    assert [r.request_id for r in results] == [dispatches[1].request_id,
                                               dispatches[0].request_id]
    for res in results:
        assert res.parent_id is None
        kids = [r for r in recs if r.parent_id == res.span_id]
        assert sorted(r.name for r in kids) == ["search.fetch", "search.format"]
        assert all(r.request_id == res.request_id for r in kids)
    for d in dispatches:
        kids = sorted(r.name for r in recs if r.parent_id == d.span_id)
        assert kids == ["search.filter", "search.scan"]
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in recs)


def test_the_deferred_device_scan_is_counted_at_dispatch_and_timed_to_its_drain(tmp_path, vecs):
    db = _db(tmp_path, vecs)
    db.find_most_similar_batch_async(vecs[:32], k=5).result()
    before = db.stats()["ops"]["device_scan"]
    delay = 0.25
    h = db.find_most_similar_batch_async(vecs[:32], k=5)
    assert db.stats()["ops"]["device_scan"]["count"] == before["count"] + 1
    time.sleep(delay)
    h.result()
    h.result()  # idempotent: the drain is timed once
    after = db.stats()["ops"]["device_scan"]
    assert after["count"] == before["count"] + 1
    assert after["total_s"] - before["total_s"] >= delay
    assert after["max_ms"] >= 1e3 * delay
    # a handle never drained counts, and adds no time
    db.find_most_similar_batch_async(vecs[:32], k=5)
    never = db.stats()["ops"]["device_scan"]
    assert never["count"] == after["count"] + 1
    assert never["total_s"] == after["total_s"]


def _delay_drains(monkeypatch, delay):
    """Each drain of a deferred result pair waits ``delay`` seconds first."""
    get = scan_ops.ResultFetch.get

    def late(self):
        time.sleep(delay)
        return get(self)

    monkeypatch.setattr(scan_ops.ResultFetch, "get", late)


def test_a_search_with_a_filter_per_query_times_each_group_to_its_drain(tmp_path, vecs,
                                                                        monkeypatch):
    db = _db(tmp_path, vecs)
    filters = [{"idx": i % 2} for i in range(32)]
    db.find_most_similar_batch(vecs[:32], k=5, metadata_filters=filters)
    before = db.stats()["ops"]["device_scan"]
    assert before["count"] == 2
    delay = 0.1
    _delay_drains(monkeypatch, delay)
    db.find_most_similar_batch(vecs[:32], k=5, metadata_filters=filters)
    after = db.stats()["ops"]["device_scan"]
    assert after["count"] == before["count"] + 2
    # both groups are dispatched before the first drain: the first is timed
    # over one delayed drain, the second over two
    assert after["total_s"] - before["total_s"] >= 3 * delay
    assert after["max_ms"] >= 1e3 * 2 * delay


def test_an_ivf_search_fetches_inside_its_scan(tmp_path, vecs):
    db = _db(tmp_path, vecs, index="ivf")
    db.find_most_similar_batch(vecs[:32], k=5)
    _, recs, t0, t1 = _traced(lambda: db.find_most_similar_batch(vecs[:32], k=5))
    by_name, by_id = _tree(recs)
    assert {n: len(v) for n, v in by_name.items()} == {
        "search": 1, "search.filter": 1, "search.scan": 1, "search.fetch": 1, "search.format": 1}
    assert _parent(by_name["search.fetch"][0], by_id) == "search.scan"
    assert db.stats()["ops"]["ivf_scan"]["count"] == 2
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in recs)


def test_a_deferred_ivf_scan_is_timed_to_its_drain(tmp_path, vecs, monkeypatch):
    db = _db(tmp_path, vecs, index="ivf")
    db.find_most_similar_batch_async(vecs[:32], k=5).result()
    before = db.stats()["ops"]["ivf_scan"]
    delay = 0.1
    _delay_drains(monkeypatch, delay)
    h = db.find_most_similar_batch_async(vecs[:32], k=5)
    assert db.stats()["ops"]["ivf_scan"]["count"] == before["count"] + 1
    h.result()
    after = db.stats()["ops"]["ivf_scan"]
    assert after["count"] == before["count"] + 1
    assert after["total_s"] - before["total_s"] >= delay


def test_an_embed_call_is_tokenize_device_and_fetch(model):
    texts = ["i like dogs", "the sky is blue", "cars"]
    model.extract_embeddings_batch(texts)
    out, recs, t0, t1 = _traced(lambda: [model.extract_embeddings_batch(texts)
                                         for _ in range(2)])
    assert len(out) == 2 and out[0].shape[0] == 3
    by_name, by_id = _tree(recs)
    assert {n: len(v) for n, v in by_name.items()} == {
        "embed": 2, "embed.tokenize": 2, "embed.device": 2, "embed.fetch": 2}
    for name in ("embed.tokenize", "embed.device", "embed.fetch"):
        assert {_parent(r, by_id) for r in by_name[name]} == {"embed"}
    for root in by_name["embed"]:
        kids = sorted((r for r in recs if r.parent_id == root.span_id), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == ["embed.tokenize", "embed.device", "embed.fetch"]
        assert all(r.request_id == root.request_id for r in kids)
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in kids)
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in recs)


def test_an_embed_call_on_the_host_route_is_tokenize_and_host(model, monkeypatch):
    enc = model.model
    monkeypatch.setattr(enc, "_host_capable", lambda: True)

    class HostRouter:
        dev_ema = host_ema = None

        def choose(self):
            return "host"

        def record(self, which, seconds):
            pass

    monkeypatch.setattr(enc, "_router", HostRouter())
    _, recs, t0, t1 = _traced(lambda: model.extract_embeddings_batch(["i like dogs"]))
    by_name, by_id = _tree(recs)
    assert {n: len(v) for n, v in by_name.items()} == {
        "embed": 1, "embed.tokenize": 1, "embed.host": 1}
    assert _parent(by_name["embed.host"][0], by_id) == "embed"
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in recs)


def test_a_training_step_is_upload_forward_backward_optimizer():
    step, enc, opt, batch = _train_setup()

    def steps():
        nonlocal enc, opt
        for _ in range(2):
            enc, opt, m = step(enc, opt, batch)
        return float(m["loss"])

    loss, recs, t0, t1 = _traced(steps)
    assert np.isfinite(loss)
    by_name, by_id = _tree(recs)
    parts = ["train.upload", "train.forward", "train.backward", "train.optimizer"]
    assert {n: len(v) for n, v in by_name.items()} == {"train.step": 2, **{p: 2 for p in parts}}
    for root in by_name["train.step"]:
        assert root.parent_id is None
        kids = sorted((r for r in recs if r.parent_id == root.span_id), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == parts
        assert all(r.request_id == root.request_id for r in kids)
        # on the CPU no CUDA event is recorded
        assert all(r.device_ms is None for r in kids)
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in recs)


def test_the_log_drops_its_oldest_records_past_its_bound(monkeypatch):
    log = telemetry.SpanLog(4)
    monkeypatch.setattr(telemetry, "_LOG", log)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(7):
            with telemetry.span(f"s{i}"):
                pass
    assert [r.name for r in log.records()] == ["s3", "s4", "s5", "s6"]
    assert log.dropped == telemetry.spans_dropped() == 3
    telemetry.clear_spans()
    assert log.records() == [] and log.dropped == 0


def test_a_request_id_given_makes_a_root():
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("outer"):
            rid = telemetry.current_request()
            with telemetry.span("again", request=rid):
                with telemetry.span("inner"):
                    pass
        with telemetry.span("other"):
            pass
    by_name, by_id = _tree(telemetry.spans())
    assert by_name["again"][0].parent_id is None
    assert by_name["again"][0].request_id == rid
    assert _parent(by_name["inner"][0], by_id) == "again"
    assert by_name["other"][0].request_id != rid


def test_threads_keep_their_own_nesting_and_lose_no_record():
    n_threads, per = 12, 200
    errors = []

    def work():
        try:
            for _ in range(per):
                with telemetry.span("root"):
                    with telemetry.span("child"):
                        pass
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    recs = telemetry.spans()
    assert len(recs) == 2 * n_threads * per
    by_name, by_id = _tree(recs)
    assert len({r.span_id for r in recs}) == len(recs)
    assert len({r.request_id for r in by_name["root"]}) == n_threads * per
    for c in by_name["child"]:
        p = by_id[c.parent_id]
        assert p.name == "root" and p.thread_id == c.thread_id
        assert p.request_id == c.request_id


def test_timed_keeps_its_counters_and_opens_its_span():
    t = telemetry.Telemetry()
    with profile(activities=[ProfilerActivity.CPU]):
        with t.timed("device_scan", "search.scan"):
            pass
        with t.timed("ivf_build"):
            pass
    with t.timed("device_scan", "search.scan"):
        pass
    snap = t.snapshot()
    assert snap["device_scan"]["count"] == 2 and snap["ivf_build"]["count"] == 1
    assert [r.name for r in telemetry.spans()] == ["search.scan", "ivf_build"]
