"""The program's spans against made-up device events: clipping to the traced
window, idle time by the innermost span, and the five readers that read
them."""

import sys
import types

import pytest

from portbench import harness, spans, trace
from portbench.tests.test_portbench_trace import Ev


def rec(name, start, end, sid, parent=None, request=1, thread=7, device_ms=None):
    return spans.Span(name, start, end, sid, parent, request, thread, device_ms)


def profile():
    """Device busy 100-170, 300-310, 700-740 of the window 0-1000."""
    events = [Ev("k1", "CUDA", 100, 50, corr=1), Ev("k2", "CUDA", 140, 30, corr=2),
              Ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 300, 10, corr=3),
              Ev("k3", "CUDA", 700, 40, corr=4)]
    return trace.reduce(events, 0, 1000, [])


def run_of(root, cell, traced=True):
    run = harness.Run(harness.load_cell(root, cell), 1, 10.0, traced, "cuda")
    run.profile = profile() if traced else None
    return run


@pytest.fixture
def port_log(monkeypatch):
    """Stands in for the port's telemetry module with the given records."""
    def install(records):
        mod = types.SimpleNamespace(spans=lambda: list(records))
        monkeypatch.setitem(sys.modules, spans.PORT_TELEMETRY, mod)
    return install


# two search calls: request 1 from 0 to 420, request 2 from 600 to 900
SEARCH = [
    rec("search.filter", 10, 40, 2, 1),
    rec("search.fetch", 90, 330, 4, 3),
    rec("search.scan", 50, 340, 3, 1),
    rec("search.format", 340, 400, 5, 1),
    rec("search", 0, 420, 1),
    rec("search.filter", 610, 620, 7, 6, request=2),
    rec("search.scan", 630, 760, 8, 6, request=2),
    rec("search.fetch", 650, 760, 9, 8, request=2),
    rec("search.format", 760, 880, 10, 6, request=2),
    rec("search", 600, 900, 6, request=2),
]


def test_nothing_to_read_gives_none(root, port_log):
    run = run_of(root, "cohere-1m-768.serial-k100", traced=False)
    port_log(SEARCH)
    assert spans.program_spans(run) is None and spans.idle_by_span(run) is None
    run = run_of(root, "cohere-1m-768.serial-k100")
    port_log([])
    assert spans.program_spans(run) is None and spans.idle_by_span(run) is None
    for name in ("dispatch_ms.search", "format_ms.search", "tokenize_ms.embed",
                 "forward_ms.train", "backward_ms.train"):
        assert harness.reader(root, name)(run) is None, name


def test_a_program_without_a_span_log_gives_none(root, monkeypatch):
    run = run_of(root, "cohere-1m-768.serial-k100")
    monkeypatch.setitem(sys.modules, spans.PORT_TELEMETRY, types.SimpleNamespace())
    assert spans.port_log() is None and spans.program_spans(run) is None
    monkeypatch.delitem(sys.modules, spans.PORT_TELEMETRY)
    assert spans.port_log() is None
    for name in ("dispatch_ms.search", "format_ms.search"):
        assert harness.reader(root, name)(run) is None, name


def test_spans_are_clipped_to_the_traced_window(root):
    run = run_of(root, "cohere-1m-768.serial-k100")
    log = [rec("before", -50, -10, 1), rec("across", -20, 30, 2),
           rec("inside", 200, 300, 3), rec("after", 990, 1200, 4), rec("later", 1000, 1100, 5)]
    got = spans.program_spans(run, log)
    assert [(s.name, s.start_ns, s.end_ns) for s in got] == [
        ("across", 0, 30), ("inside", 200, 300), ("after", 990, 1000)]


def test_each_idle_stretch_goes_to_the_innermost_span(root):
    run = run_of(root, "cohere-1m-768.serial-k100")
    idle = spans.idle_by_span(run, SEARCH)
    # gaps 0-100 (mid 50: the scan has begun), 170-300 (mid 235: the fetch
    # inside the scan), 310-700 (mid 505: between the calls), 740-1000 (mid
    # 870: the second call's formatting)
    assert idle == pytest.approx({"search.scan": 100e-9, "search.fetch": 130e-9,
                                  spans.OUTSIDE: 390e-9, "search.format": 260e-9})
    assert sum(idle.values()) == pytest.approx(run.profile.window_s - run.profile.busy_s)


def test_a_root_that_covers_a_gap_alone_takes_it(root):
    run = run_of(root, "cohere-1m-768.serial-k100")
    log = [rec("a", 0, 60, 2, 1), rec("b", 62, 90, 3, 1), rec("root", 0, 1000, 1)]
    idle = spans.idle_by_span(run, log)
    # 0-100 (mid 50) is in "a"; every later gap only in the root
    assert idle == pytest.approx({"a": 100e-9, "root": (130 + 390 + 260) * 1e-9})


def test_the_search_readers(root, port_log):
    run = run_of(root, "cohere-1m-768.serial-k100")
    port_log(SEARCH)
    # from the root's start to the first fetch's: 90 and 50 ns
    assert harness.reader(root, "dispatch_ms.search")(run) == pytest.approx(1e-6 * 70)
    assert harness.reader(root, "format_ms.search")(run) == pytest.approx(1e-6 * 90)
    # a request with two formats (a filter per query) counts once
    port_log(SEARCH + [rec("search.format", 880, 890, 11, 6, request=2)])
    assert harness.reader(root, "format_ms.search")(run) == pytest.approx(1e-6 * 95)
    # a call without a fetch (a host-routed scan) has no dispatch time
    port_log([r for r in SEARCH if not (r.name == "search.fetch" and r.request_id == 2)])
    assert harness.reader(root, "dispatch_ms.search")(run) == pytest.approx(1e-6 * 90)


def test_the_embed_reader(root, port_log):
    run = run_of(root, "me5-large.ingest-f32")
    port_log([rec("embed.tokenize", 0, 40, 2, 1), rec("embed.device", 40, 90, 3, 1),
              rec("embed", 0, 200, 1), rec("embed.tokenize", 300, 360, 5, 4, request=2),
              rec("embed", 300, 500, 4, request=2)])
    assert harness.reader(root, "tokenize_ms.embed")(run) == pytest.approx(1e-6 * 50)


def test_the_training_readers(root, port_log):
    run = run_of(root, "me5-large.train-f32")
    port_log([rec("train.forward", 10, 20, 2, 1, device_ms=240.0),
              rec("train.backward", 20, 30, 3, 1, device_ms=500.0),
              rec("train.optimizer", 30, 40, 4, 1, device_ms=16.0),
              rec("train.step", 0, 50, 1),
              rec("train.forward", 510, 520, 6, 5, request=2, device_ms=260.0),
              rec("train.backward", 520, 530, 7, 5, request=2, device_ms=520.0),
              rec("train.step", 500, 550, 5, request=2),
              # a step on the CPU records no device time
              rec("train.forward", 600, 610, 9, 8, request=3)])
    assert harness.reader(root, "forward_ms.train")(run) == pytest.approx(250.0)
    assert harness.reader(root, "backward_ms.train")(run) == pytest.approx(510.0)
    assert spans.mean_device_ms(run, "train.optimizer") == pytest.approx(16.0)


def test_the_new_metrics_are_listed_for_their_cells(root):
    want = {"me5-large.ingest-f32": {"tokenize_ms.embed"},
            "cohere-1m-768.serial-k100": {"dispatch_ms.search", "format_ms.search"},
            "me5-large.train-f32": {"forward_ms.train", "backward_ms.train"}}
    for cell, names in want.items():
        per_layer = {m["name"]: m for m in harness.load_cell(root, cell).per_layer}
        assert names <= set(per_layer), cell
        assert all(per_layer[n]["source"] == "program_span" for n in names)
