"""Each cell, cut to a size the CPU runs, driven end to end through the
port and held against the reference: correct on the sound program, and not
correct with the timed path broken underneath, once for each fault the
cell can have. The look for a card is skipped: these run on the CPU.

The cells are BENCHMARK.json's and the batch cell kept out of it; the
faults are their drivers', in ``portbench/tests/faults/<driver>.py``. A
cell or driver added as new files is dry-run here with no edit."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT
from portbench.tests.tiny import BATCH, dry_run, with_batch_cell


def cells(root: str = ROOT) -> list[str]:
    """Every cell of BENCHMARK.json, and the batch cell kept out of it."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return [BATCH] + [w["name"] for w in json.load(f)["workloads"]]


def faults(name: str, root: str = ROOT) -> dict:
    """The faults of the cell's driver: ``FAULTS`` of
    ``portbench/tests/faults/<driver>.py`` ({id: plant(monkeypatch)})."""
    bench = with_batch_cell(root) if name == BATCH else None
    drv = harness.load_cell(root, name, bench).traffic["driver"]
    return importlib.import_module(f"portbench.tests.faults.{drv}").FAULTS


def fault_cases():
    """(cell, fault, id) of every cell and each fault of its driver; the id
    is the mix's first word and the fault's name, or the cell's whole name
    where an earlier cell took that id."""
    out, seen = [], set()
    for name in cells():
        for fid, plant in faults(name).items():
            short = f"{name.split('.', 1)[1].split('-')[0]}-{fid}"
            out.append(pytest.param(name, plant, id=short if short not in seen else f"{name}-{fid}"))
            seen.add(short)
    return out


CELLS = cells()


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(root, name):
    run = dry_run(root, name)
    line = harness.result_line(root, run, "cpu")
    assert line["correct"], line
    assert run.items_done > 0 and run.failed == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_same_seed_gives_the_same_inputs(root, name):
    from portbench.tests.tiny import tiny_cell
    from portbench import traffic
    cell = tiny_cell(root, name)
    if "mixture" in cell.config:  # a corpus of vectors
        from portbench.drivers.search import inputs
        a = inputs(cell.config, 64, 2 ** 35 + 3, "cpu")
        b = inputs(cell.config, 64, 2 ** 35 + 3, "cpu")
        c = inputs(cell.config, 64, 2 ** 35 + 4, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])
    if "model" in cell.config:  # an encoder's weights
        a = traffic.make_weights(cell.config["model"], 7, "cpu")
        b = traffic.make_weights(cell.config["model"], 7, "cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
    for spec in (cell.traffic.get("chunk"), cell.traffic.get("passage")):
        if spec is None:
            continue
        t1, l1 = traffic.text_pool(spec, 40, 3, 5)
        t2, l2 = traffic.text_pool(spec, 40, 3, 5)
        t3, l3 = traffic.text_pool(spec, 40, 3, 6)
        assert t1 == t2 and l1 == l2
        # another seed: the same multiset of sizes in another order
        assert sorted(l1) == sorted(l3) and l1 != l3


@pytest.mark.parametrize("name,fault", fault_cases())
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    run = dry_run(root, name)
    line = harness.result_line(root, run, "cpu")
    assert not line["correct"], line["checks"]
    failed = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert failed, line["checks"]


def test_a_failing_call_is_counted_and_not_correct(root, monkeypatch):
    from minivectordb_tpu_torch import VectorDatabase
    real, calls = VectorDatabase.find_most_similar, []

    def boom(self, *a, **k):
        calls.append(1)
        if len(calls) > 3:  # past the warm-up: every call of the window
            raise RuntimeError("planted")
        return real(self, *a, **k)

    monkeypatch.setattr(VectorDatabase, "find_most_similar", boom)
    run = dry_run(root, "cohere-1m-768.serial-k100", seconds=0.3)
    assert run.failed == run.attempted > 0
    assert not harness.is_correct(run)


def test_the_chunk_mix_keeps_its_shares():
    from portbench import traffic
    lengths = traffic.fixed_lengths(1536, {"full_share": 0.75, "tail_min": 64,
                                           "tail_max": 511, "max_tokens": 512})
    assert lengths.count(512) == 1152
    tails = [n for n in lengths if n != 512]
    assert min(tails) >= 64 and max(tails) <= 511
    assert np.mean(tails) == pytest.approx(287.5, abs=1.0)
