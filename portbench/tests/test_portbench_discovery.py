"""Configurations, traffic mixes and metrics are files found by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


def test_every_workload_finds_its_files(root, bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(root, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["driver"] in {"search", "embed", "train"}
        assert harness.driver(cell.traffic["driver"]).run
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_every_metric_has_a_reader(root, bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(root, m["name"])), m["name"]


def test_names_units_and_entries(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["why"]) <= 200
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {"host_clock", "device_trace"}
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        names.append(m["name"])
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_a_new_cell_is_picked_up_by_adding_files_only(root, tmp_path):
    """A copy of the benchmark gains a cell: a new mix file and entries added
    to BENCHMARK.json. No file of portbench/ is edited, and the harness
    finds the cell, its configuration, its mix, its driver and its
    metrics' readers by name."""
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    mix = dict(json.loads((tmp_path / "portbench/mixes/b256-k100.json").read_text()), k=10)
    (tmp_path / "portbench/mixes/b256-k10.json").write_text(json.dumps(mix))
    new = "cohere-1m-768.b256-k10"
    bench["workloads"].append({"name": new, "config": "cohere-1m-768",
                               "traffic": "b256-k10", "chips": 1, "why": "k = 10"})
    for m in bench["end_to_end"]:
        if "cohere-1m-768.serial-k100" in m.get("workloads", []):
            m["workloads"].append(new)
    bench["per_layer"].append({"name": "k1_f32_roofline", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "phase-1 kernels",
                               "moves": "search_qps", "workloads": [new]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(str(tmp_path), new)
    assert cell.traffic["k"] == 10 and cell.config["rows"] == 1_000_000
    assert harness.driver(cell.traffic["driver"]).run
    assert {m["name"] for m in cell.end_to_end} == {"search_qps", "search_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"k1_f32_roofline"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(str(tmp_path), m["name"]))
    assert all(p.read_bytes() == b for p, b in before.items())


def test_an_unknown_workload_is_refused(root):
    with pytest.raises(SystemExit):
        harness.load_cell(root, "no-such.cell")
