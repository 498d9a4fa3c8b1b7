"""Configurations, traffic mixes, drivers, model families and metrics are
files found by name, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import families, harness

# what every driver and every model family module exposes (see
# portbench/harness.py and portbench/families/__init__.py)
DRIVER_API = ("run", "check", "control", "control_answers", "tiny")
FAMILY_API = ("weight_shapes", "to_pytree", "from_pytree", "embed", "forward_flops",
              "attention", "tiny")

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
        drv = cell.traffic["driver"]
        assert os.path.isfile(os.path.join(root, "portbench", "drivers", drv + ".py")), drv
        assert all(callable(getattr(harness.driver(drv), f, None)) for f in DRIVER_API), drv
        if "model" in cell.config:
            fam = families.of(cell.config["model"])
            assert all(callable(getattr(fam, f, None)) for f in FAMILY_API), fam.__name__
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


def copy_of(root, tmp_path):
    """portbench/ copied under ``tmp_path``: (BENCHMARK.json's contents,
    {path: bytes} of every file of the copy)."""
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    return bench, before


def test_a_new_cell_is_picked_up_by_adding_files_only(root, tmp_path):
    """A copy of the benchmark gains a cell: a new mix file and entries added
    to BENCHMARK.json. No file of portbench/ is edited, and the harness
    finds the cell, its configuration, its mix, its driver and its
    metrics' readers by name."""
    bench, before = copy_of(root, tmp_path)
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


NEW_FAMILY = '''"""XLM-R's encoder under another model_type, with a reference forward
that counts its calls and a FLOP count of its own."""
from portbench.families import xlm_roberta as base
from portbench.families.xlm_roberta import (  # noqa: F401
    attention, from_pytree, tiny, to_pytree, weight_shapes)

CALLS = []


def embed(w, ids, mask, cfg):
    CALLS.append(tuple(ids.shape))
    return base.embed(w, ids, mask, cfg)


def forward_flops(cfg, lengths):
    return 2.0 * base.forward_flops(cfg, lengths)
'''

NEW_DRIVER = '''"""The embed loop under another name, with a control and a CPU cut of
its own."""
from portbench.drivers import embed
from portbench.drivers.embed import check, run  # noqa: F401


def control_answers(mix):
    return 3


def control(run, answers):
    return embed.control(run, answers)


def tiny(config, mix):
    mix.update(batch=2, pool_batches=3, check_texts=4,
               chunk={"full_share": 0.5, "tail_min": 8, "tail_max": 30, "max_tokens": 32})
'''

# run in the copy, so that every portbench module comes from it; the port
# comes from the checkout
IN_THE_COPY = '''
import json, sys
copy, checkout, name = sys.argv[1:4]
sys.path[:0] = [copy]
sys.path.append(checkout)
import pytest, torch
import portbench
assert portbench.__file__.startswith(copy), portbench.__file__
from portbench import control, counts, families, harness
from portbench.families import xlm_roberta
from portbench.tests import test_portbench_dry_run as dry
from portbench.tests.tiny import dry_run, tiny_cell

out = {"cells": dry.cells(copy), "fault_ids": [p.id for p in dry.fault_cases()]}
cell = harness.load_cell(copy, name)
fam = families.of(cell.config["model"])
out["found"] = [fam.__name__, harness.driver(cell.traffic["driver"]).__name__]
run = dry_run(copy, name)
out["correct"] = harness.is_correct(run)
out["batch"] = run.cell.traffic["batch"]
out["reference_calls"] = len(fam.CALLS)

class Profile:
    window_s = 2.0

run.profile = Profile()
model = run.cell.config["model"]
out["mfu"] = harness.reader(copy, "embed_mfu_pct")(run)
out["family_mfu"] = counts.mfu_share(
    sum(fam.forward_flops(model, c) for c in run.facts["calls"]), 2.0)
out["xlm_roberta_mfu"] = counts.mfu_share(
    sum(xlm_roberta.forward_flops(model, c) for c in run.facts["calls"]), 2.0)

fn, answers = control.control_of(cell)
out["control"] = [fn.__module__, answers]
crun = harness.Run(tiny_cell(copy, name), 5, 0.0, False, "cpu")
fn(crun, answers)
out["control_checks"] = sorted(crun.checks)

broken = []
for fid, plant in dry.faults(name, copy).items():
    with pytest.MonkeyPatch.context() as mp:
        plant(mp)
        broken.append([fid, harness.is_correct(dry_run(copy, name))])
out["faults"] = broken
print(json.dumps(out))
'''


def test_a_new_family_and_driver_join_by_adding_files_only(root, tmp_path):
    """A copy of the benchmark gains a model family (a new ``model_type``),
    a driver under a new name, a configuration and a mix that name them,
    a fault file for the driver, and entries in BENCHMARK.json, with no
    existing file of portbench/ edited. The cell is found and dry-run
    against that family's reference, a planted fault makes it not
    correct, control.py finds the driver's control, and embed_mfu_pct
    reads the family's FLOPs."""
    bench, before = copy_of(root, tmp_path)
    pb = tmp_path / "portbench"
    (pb / "families/toy_encoder.py").write_text(NEW_FAMILY)
    (pb / "drivers/embed_small.py").write_text(NEW_DRIVER)
    (pb / "tests/faults/embed_small.py").write_text(
        "from portbench.tests.faults.embed import FAULTS  # noqa: F401\n")
    config = json.loads((pb / "configs/me5-large.json").read_text())
    config["name"] = "toy-large"
    config["model"]["model_type"] = "toy-encoder"
    (pb / "configs/toy-large.json").write_text(json.dumps(config))
    mix = dict(json.loads((pb / "mixes/ingest-f32.json").read_text()), driver="embed_small")
    (pb / "mixes/toy-ingest.json").write_text(json.dumps(mix))
    new = "toy-large.toy-ingest"
    bench["configs"].append({"name": "toy-large", "source": "https://example.org/toy",
                             "file": "portbench/configs/toy-large.json", "reduced": [],
                             "why": "a family and a driver added as files"})
    bench["workloads"].append({"name": new, "config": "toy-large", "traffic": "toy-ingest",
                               "chips": 1, "why": "the new family through the new driver"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("embed_tokens_per_s", "embed_mfu_pct"):
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    got = subprocess.run([sys.executable, "-c", IN_THE_COPY, str(tmp_path), root, new],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert new in out["cells"] and "toy-large.toy-ingest-altered-answer" not in out["fault_ids"]
    assert "toy-altered-answer" in out["fault_ids"]
    assert out["found"] == ["portbench.families.toy_encoder", "portbench.drivers.embed_small"]
    assert out["correct"] and out["batch"] == 2 and out["reference_calls"] >= 1
    assert out["mfu"] == out["family_mfu"] == pytest.approx(2 * out["xlm_roberta_mfu"])
    assert out["control"] == ["portbench.drivers.embed_small", 3]
    assert out["control_checks"] == ["bad_answers", "embed_gap"]
    assert out["faults"] == [["altered-answer", False]]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_an_unknown_workload_is_refused(root):
    with pytest.raises(SystemExit):
        harness.load_cell(root, "no-such.cell")
