"""The trace's reduction and the per-layer readers, on made-up events."""

import pytest

from portbench import counts, harness, trace


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, user=False):
        self._v = (name, dev, start, dur, corr, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def profile(spans=()):
    events = [
        Ev("phase1_tf32_kernel<2, 4>", "CUDA", 100, 50, corr=1),
        Ev("topk_kernel", "CUDA", 140, 30, corr=2),          # overlaps the first
        Ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 300, 10, corr=3),
        Ev("bench.span", "CUDA", 0, 1000, user=True),         # mirrored annotation
        Ev("Optimizer.step#AdamW.step", "CPU", 600, 100),
        Ev("cudaLaunchKernel", "CPU", 650, 5, corr=4),
        Ev("cudaLaunchKernel", "CPU", 50, 5, corr=1),
        Ev("multi_tensor_apply_kernel", "CUDA", 700, 40, corr=4),
    ]
    return trace.reduce(events, 0, 1000, list(spans), ranges=("Optimizer.step",))


def test_busy_is_the_union_of_device_operations():
    p = profile()
    assert p.busy_intervals() == [[100, 170], [300, 310], [700, 740]]
    assert p.busy_s == pytest.approx(120e-9)
    assert p.window_s == pytest.approx(1e-6)
    assert [op.name for op in p.kernels(r"phase1_\w*kernel")] == ["phase1_tf32_kernel<2, 4>"]


def test_a_range_counts_the_device_time_of_what_it_launched():
    assert profile().ranges["Optimizer.step"] == pytest.approx(40e-9)


def test_idle_time_goes_to_the_span_that_covered_it():
    p = profile(spans=[("dispatch", 0, 90), ("result", 180, 400)])
    idle = p.idle_by_host()
    assert idle["dispatch"] == pytest.approx(100e-9)      # 0-100
    assert idle["result"] == pytest.approx(130e-9)        # 170-300
    assert idle["between calls"] == pytest.approx((390 + 260) * 1e-9)
    assert sum(idle.values()) == pytest.approx(p.window_s - p.busy_s)
    b = p.breakdown()
    assert b["device_ops"][0][0] == "phase1_tf32_kernel<2, 4>" and len(b["idle_gaps"]) == 3


def test_readers_read_the_trace(root):
    from portbench.tests.tiny import BATCH, with_batch_cell
    cell = harness.load_cell(root, BATCH, with_batch_cell(root))
    run = harness.Run(cell, 1, 10.0, True, "cuda")
    run.profile = profile(spans=[("dispatch", 0, 90), ("result", 180, 400)])
    run.spans = run.profile.spans
    run.facts.update(rows=1_000_000, dim=768, batch=256, k=100)
    least = counts.least_seconds(*counts.phase1_work(1_000_000, 768, 256))
    assert harness.reader(root, "k1_f32_roofline")(run) == pytest.approx(100 * least / 50e-9)
    # every kernel but phase 1, per search (one "result" span)
    assert harness.reader(root, "fused_phase23_ms")(run) == pytest.approx(1e3 * 70e-9)
    assert harness.reader(root, "dispatch_ms.batch256")(run) == pytest.approx(90e-6)
    assert harness.reader(root, "device_idle_pct.search")(run) == pytest.approx(88.0)


def test_readers_with_nothing_to_read_return_none(root):
    cell = harness.load_cell(root, "me5-large.train-f32")
    run = harness.Run(cell, 1, 10.0, False, "cuda")
    for m in cell.per_layer:
        assert harness.reader(root, m["name"])(run) is None, m["name"]
